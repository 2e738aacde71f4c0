"""Instance-segmentation experiment: the fields of
unicorn_tpu/exp/det_mask.py ExpDetMask, get_model() building the port's
YOLOXDet with the CondInst controllers and mask branch, get_inst_forward(),
the training factories get_optimizer (SGD; with train_mask_only only
the controllers and the mask branch train) and get_train_step, and
load_pretrained (the detector's weights), get_data_loader: InstLoader
over the on-disk COCO instances (COCOMOTSDataset, polygon and RLE masks),
and get_evaluator: box and mask AP over the COCO val set
(COCOInstEvaluator)."""
from __future__ import annotations

import os
from dataclasses import replace

import torch

from ..core.checkpoint import load_checkpoint, load_matching
from ..core.train_step import make_det_mask_train_step
from ..data.datasets.vos import COCOMOTSDataset
from ..data.loader import InstLoader
from ..data.transforms import TrainTransformIns
from ..drivers.inst import InstForward, make_inst_forward
from ..evaluators.coco_inst_evaluator import COCOInstEvaluator
from ..models.unicorn import YOLOXDet
from .det import ExpDet, get_unicorn_datadir

MASK_PARAM_KEYS = ("controller", "mask_branch")


def mask_only_trainable(named_params) -> dict:
    """{name: True where the parameter belongs to the CondInst branch}: the
    head's controllers (`head.controllers.*`) and the mask branch
    (`head.mask_branch.*`), the tensors JAX's rule selects on flax paths
    (`head/controller*`, `mask_branch/*`)."""
    return {name: any(k in name for k in MASK_PARAM_KEYS)
            for name, _ in named_params}


def mask_only(tx, on: bool):
    """The update rule `tx`; with `on`, only the controllers and the mask
    branch train (the rest neither moves nor decays)."""
    return replace(tx, trainable_mask_fn=mask_only_trainable) if on else tx


class ExpDetMask(ExpDet):
    def __init__(self):
        super().__init__()
        self.task = "inst"
        self.exp_name = "unicorn_inst"
        self.train_mask_only = True
        self.d_rate = 4
        # BoxInst box-supervised masks (losses/boxinst.py), off by default
        self.boxinst = False
        self.boxinst_warmup_iters = 10000
        self.max_epoch = 12
        self.pretrain_name = "unicorn_det_convnext_tiny_800x1280"

    def get_model(self, generator: torch.Generator | None = None) -> YOLOXDet:
        return YOLOXDet(**self._model_fields(), use_mask=True,
                        generator=generator)

    def get_inst_forward(self, model: YOLOXDet,
                         device="cuda") -> InstForward:
        """decode + NMS + CondInst mask decode at the test thresholds, on
        `device` (the card unless the caller asks for the CPU)."""
        return make_inst_forward(
            model, num_classes=self.num_classes, conf_thre=self.test_conf,
            nms_thre=self.nmsthre, use_raft=getattr(self, "use_raft", False),
            up_rate=getattr(self, "up_rate", 8 // self.d_rate),
            device=device)

    def get_evaluator(self, batch_size=1, device="cuda") -> COCOInstEvaluator:
        """Box and mask AP over the val set at the test thresholds, one
        image at a time (the per-instance mask decode runs at batch 1;
        batch_size is taken for the exps' common signature)."""
        return COCOInstEvaluator(
            dataset=self.get_eval_dataset(), img_size=self.test_size,
            conf_thre=self.test_conf, nms_thre=self.nmsthre,
            num_classes=self.num_classes, d_rate=self.d_rate, device=device)

    def eval(self, model, evaluator, max_images=None):
        """get_evaluator()'s evaluator on `model` through the CondInst
        forward (get_inst_forward)."""
        return evaluator.evaluate(
            self.get_inst_forward(model, device=evaluator.device),
            max_images=max_images)

    def get_optimizer(self, batch_size, iters_per_epoch=1000):
        """The parent's update rule, mask-only with train_mask_only."""
        return mask_only(super().get_optimizer(batch_size, iters_per_epoch),
                         self.train_mask_only)

    def get_train_step(self, batch_size):
        """step(state, images (B, 3, H, W), labels (B, M, 5), masks (B, M,
        H / d_rate, W / d_rate)) -> (state, loss_dict)."""
        del batch_size  # shapes are the batch's own
        return make_det_mask_train_step(
            self.input_size, use_l1=self.always_l1, boxinst=self.boxinst,
            boxinst_warmup_iters=self.boxinst_warmup_iters,
            d_rate=self.d_rate)

    def get_data_loader(self, batch_size):
        """InstLoader over COCOMOTSDataset(data_dir or <datadir>/coco,
        train_ann, train_name) with TrainTransformIns (masks at
        1 / d_rate), seeded from `seed` (0 when None), data_num_workers
        threads."""
        data_dir = self.data_dir or os.path.join(get_unicorn_datadir(), "coco")
        return InstLoader(
            COCOMOTSDataset(data_dir, self.train_ann, self.train_name),
            TrainTransformIns(max_labels=self.max_labels,
                              flip_prob=self.flip_prob,
                              hsv_prob=self.hsv_prob, d_rate=self.d_rate),
            batch_size, self.input_size, seed=self.seed or 0,
            workers=self.data_num_workers)

    def load_pretrained(self, state_dict: dict) -> dict:
        """Detector -> inst-stage init: every tensor of the detector
        checkpoint's EMA weights (its weights when it has none), from
        <cwd>/Unicorn_outputs/<pretrain_name>/latest, whose name and shape
        match; the controllers and the mask branch stay at their init."""
        det = load_checkpoint(os.path.join(os.getcwd(), "Unicorn_outputs",
                                           self.pretrain_name))
        return load_matching(state_dict, det.get("ema_model") or det["model"])
