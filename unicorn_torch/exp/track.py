"""Unified SOT+MOT experiment: the model, training and test fields of
unicorn_tpu/exp/track.py ExpTrack, get_model() building the port's Unicorn
(any of its interaction modes, `interact_mode`), and the training factories
get_lr_fn / get_optimizer / get_train_step. The loader, the evaluators, the
trainer, checkpoints and `load_pretrained` are not ported yet."""
from __future__ import annotations

import torch

from ..core.schedule import warm_cos_lr_fn
from ..core.train_state import default_wd_mask, make_optimizer
from ..core.train_step import make_uni_train_step
from ..models.unicorn import Unicorn


class ExpTrack:
    def __init__(self):
        self.task = "uni"
        self.exp_name = "unicorn_track"
        # ---------------- model config ---------------- #
        self.num_classes = 8
        self.depth = 1.0
        self.width = 1.0
        self.act = "silu"
        self.backbone_name = "convnext_tiny"
        self.in_channels = [192, 384, 768]
        self.embed_dim = 128
        self.interact_mode = "deform"
        self.use_attention = True
        self.n_layer_att = 3
        self.unshared_obj = True
        self.unshared_reg = True
        self.fuse_method = "sum"
        self.learnable_fuse = True
        self.bf16 = True
        # serving runs the interaction and embedding stages in bf16 too
        self.serve_interact_bf16 = True
        # backbone block remat is not ported yet (same numbers, less memory)
        self.remat = False
        self.input_size = (800, 1280)
        # --------------  training config --------------------- #
        self.warmup_epochs = 1
        self.max_epoch = 15
        self.warmup_lr = 0
        self.basic_lr_per_img = 5e-4 / 64.0
        self.scheduler = "yoloxwarmcos"
        self.no_aug_epochs = 3
        self.min_lr_ratio = 0.1
        self.ema = True
        self.mhs = True
        self.weight_decay = 5e-4
        self.always_l1 = True
        self.use_grad_acc = True
        self.grad_acc_step = 2
        self.bidirect = True
        self.train_mode = "alter"
        self.alter_step = 1
        self.mot_weight = 3
        self.scale_all_mot = True
        # -----------------  testing config ------------------ #
        self.test_size = (800, 1280)
        self.test_conf = 0.01
        self.nmsthre = 0.65

    def get_model(self, generator: torch.Generator | None = None,
                  serve: bool = False, msda_method: str = "auto") -> Unicorn:
        """The Unicorn of this experiment, on the CPU, parameters drawn
        from `generator` (seed 0 when None). serve=True gives the model the
        test tools serve: with `serve_interact_bf16`, its interaction and
        embedding stages compute in bf16 (training keeps them fp32)."""
        idt = (torch.bfloat16 if serve and self.serve_interact_bf16
               else torch.float32)
        return Unicorn(
            num_classes=self.num_classes, depth=self.depth, width=self.width,
            in_channels=tuple(self.in_channels),
            backbone_name=self.backbone_name, act=self.act,
            interact_mode=self.interact_mode, embed_dim=self.embed_dim,
            use_attention=self.use_attention, n_layer_att=self.n_layer_att,
            unshared_obj=self.unshared_obj, unshared_reg=self.unshared_reg,
            fuse_method=self.fuse_method, learnable_fuse=self.learnable_fuse,
            remat=self.remat,
            dtype=torch.bfloat16 if self.bf16 else torch.float32,
            interact_dtype=idt, msda_method=msda_method, generator=generator,
            **self._mask_fields())

    def _mask_fields(self) -> dict:
        """Unicorn's mask-stack fields; the mask stage sets them."""
        return {}

    # ---- training factories ----

    def get_lr_fn(self, batch_size, iters_per_epoch):
        """iteration -> learning rate: quadratic warm-up, cosine, floor."""
        return warm_cos_lr_fn(self, batch_size, iters_per_epoch)

    def get_optimizer(self, batch_size, iters_per_epoch=12500):
        """AdamW, decay on kernels only, with gradient accumulation; hand it
        to core.train_state.TrainState.create with the model."""
        return make_optimizer(
            self.get_lr_fn(batch_size, iters_per_epoch), kind="adamw",
            weight_decay=self.weight_decay,
            grad_accum=self.grad_acc_step if self.use_grad_acc else 1,
            no_decay_mask_fn=default_wd_mask)

    def get_train_step(self, batch_size):
        """step(state, images (B, 2, 3, H, W), targets (B, 2, M, 6),
        task_ids (B,)) -> (state, loss_dict) at this experiment's input
        size and loss weights."""
        del batch_size  # shapes are the batch's own
        return make_uni_train_step(
            self.input_size,
            mot_weight=float(self.mot_weight) if self.scale_all_mot else 1.0,
            bidirect=self.bidirect, use_l1=self.always_l1,
            num_classes=self.num_classes, mhs=self.mhs)
