"""Detection experiment: the model, data, transform, training and test
fields of unicorn_tpu/exp/det.py ExpDet, get_model() building the port's
YOLOXDet, the training factories get_lr_fn / get_optimizer (SGD with
Nesterov momentum), the fields the trainer reads, get_unicorn_datadir (the
root of the on-disk datasets), and the mosaic pretraining data
(get_dataset: the on-disk COCO set; get_data_loader: a DetLoader over
MosaicDetection with MixUp), and its COCO evaluator over the val set
(get_eval_dataset, get_evaluator)."""
from __future__ import annotations

import os

import torch

from ..core.schedule import warm_cos_lr_fn
from ..core.train_state import default_wd_mask, make_optimizer
from ..data.datasets.coco import COCODataset
from ..data.loader import DetLoader
from ..data.mosaic import MosaicDetection
from ..data.transforms import TrainTransform, ValTransform
from ..evaluators.coco_evaluator import COCOEvaluator, decode_forward
from ..models.unicorn import YOLOXDet
from .base import BaseExp


def get_unicorn_datadir() -> str:
    """The root of the on-disk datasets: $UNICORN_DATADIR, else
    $YOLOX_DATADIR, else <cwd>/datasets."""
    return os.environ.get(
        "UNICORN_DATADIR",
        os.environ.get("YOLOX_DATADIR", os.path.join(os.getcwd(), "datasets")))


class ExpDet(BaseExp):
    def __init__(self):
        super().__init__()
        self.task = "det"
        self.exp_name = "unicorn_det"
        # ---------------- model config ---------------- #
        self.num_classes = 80
        self.depth = 1.0
        self.width = 1.0
        self.act = "silu"
        self.backbone_name = "convnext_tiny"
        self.in_channels = [192, 384, 768]
        self.use_attention = True
        self.n_layer_att = 3
        self.bf16 = True
        # backbone block remat (same numbers, less memory): False, True
        # (each trunk block recomputed in the backward) or "dw" (the dw7x7
        # output kept, the block's tail recomputed)
        self.remat = False
        self.input_size = (640, 640)
        self.data_num_workers = 1
        self.multiscale_range = 5
        # the COCO set under data_dir (None: <datadir>/coco)
        self.data_dir = None
        self.train_ann = "instances_train2017.json"
        self.train_name = "train2017"
        self.val_ann = "instances_val2017.json"
        self.val_name = "val2017"
        # --------------- transform config ----------------- #
        self.mosaic_prob = 1.0
        self.mixup_prob = 1.0
        self.hsv_prob = 1.0
        self.flip_prob = 0.5
        self.degrees = 10.0
        self.translate = 0.1
        self.mosaic_scale = (0.1, 2)
        self.mixup_scale = (0.5, 1.5)
        self.shear = 2.0
        self.enable_mixup = True
        self.max_labels = 120
        # --------------  training config --------------------- #
        self.seed = None
        self.output_dir = "./Unicorn_outputs"
        self.warmup_epochs = 1
        self.max_epoch = 100
        self.warmup_lr = 0
        self.basic_lr_per_img = 1e-3 / 64.0
        self.scheduler = "yoloxwarmcos"
        self.no_aug_epochs = 5
        self.min_lr_ratio = 0.025
        self.ema = True
        self.always_l1 = False
        self.weight_decay = 5e-2
        self.momentum = 0.9
        self.print_interval = 10
        self.debug_only = False
        self.eval_interval = 10
        self.use_grad_acc = False
        self.grad_acc_step = 1
        # -----------------  testing config ------------------ #
        self.test_size = (640, 640)
        self.test_conf = 0.01
        self.nmsthre = 0.65

    def _model_fields(self) -> dict:
        return dict(
            num_classes=self.num_classes, depth=self.depth, width=self.width,
            in_channels=tuple(self.in_channels),
            backbone_name=self.backbone_name, act=self.act,
            use_attention=self.use_attention, n_layer_att=self.n_layer_att,
            remat=self.remat,
            dtype=torch.bfloat16 if self.bf16 else torch.float32)

    def get_model(self, generator: torch.Generator | None = None) -> YOLOXDet:
        """The YOLOXDet of this experiment, on the CPU, parameters drawn
        from `generator` (seed 0 when None)."""
        return YOLOXDet(**self._model_fields(), generator=generator)

    # ---- training factories ----

    def get_lr_fn(self, batch_size, iters_per_epoch):
        return warm_cos_lr_fn(self, batch_size, iters_per_epoch)

    def get_optimizer(self, batch_size, iters_per_epoch=1000):
        """SGD with Nesterov momentum, decay (added before the momentum) on
        kernels only; hand it to core.train_state.TrainState.create with
        the model."""
        return make_optimizer(
            self.get_lr_fn(batch_size, iters_per_epoch), kind="sgd",
            weight_decay=self.weight_decay, momentum=self.momentum,
            grad_accum=self.grad_acc_step if self.use_grad_acc else 1,
            no_decay_mask_fn=default_wd_mask)

    def _transform(self):
        return TrainTransform(max_labels=self.max_labels,
                              flip_prob=self.flip_prob,
                              hsv_prob=self.hsv_prob)

    def get_dataset(self) -> COCODataset:
        """The COCO training set under data_dir (else <datadir>/coco)
        through TrainTransform; a missing annotation file raises
        FileNotFoundError naming it."""
        data_dir = self.data_dir or os.path.join(get_unicorn_datadir(), "coco")
        return COCODataset(data_dir=data_dir, json_file=self.train_ann,
                           name=self.train_name, img_size=self.input_size,
                           preproc=self._transform())

    def get_data_loader(self, batch_size) -> DetLoader:
        """Detection batches (images (B, H, W, 3) float32, labels (B,
        max_labels, 5)) at input_size: the COCO set through mosaic and
        MixUp where mosaic_prob > 0, seeded from the exp's seed (0 when
        None), data_num_workers threads."""
        dataset = self.get_dataset()
        if self.mosaic_prob > 0:
            dataset = MosaicDetection(
                dataset, img_size=self.input_size, preproc=self._transform(),
                mosaic_prob=self.mosaic_prob, mixup_prob=self.mixup_prob,
                degrees=self.degrees, translate=self.translate,
                mosaic_scale=self.mosaic_scale, mixup_scale=self.mixup_scale,
                shear=self.shear, enable_mixup=self.enable_mixup)
        return DetLoader(dataset, batch_size, seed=self.seed or 0,
                         workers=self.data_num_workers)

    def get_eval_dataset(self) -> COCODataset:
        """The COCO val set under data_dir (else <datadir>/coco) through
        ValTransform at test_size."""
        data_dir = self.data_dir or os.path.join(get_unicorn_datadir(), "coco")
        return COCODataset(data_dir=data_dir, json_file=self.val_ann,
                           name=self.val_name, img_size=self.test_size,
                           preproc=ValTransform())

    def get_evaluator(self, batch_size=1, device="cuda",
                      mesh=None) -> COCOEvaluator:
        """COCO box AP over the val set at the test thresholds, batches of
        batch_size on `device` (the card unless the caller asks for the
        CPU); with a "data" ProcessMesh, the images split over its ranks
        (COCOEvaluator)."""
        return COCOEvaluator(
            dataset=self.get_eval_dataset(), img_size=self.test_size,
            conf_thre=self.test_conf, nms_thre=self.nmsthre,
            num_classes=self.num_classes, batch_size=batch_size,
            device=device, mesh=mesh)

    def eval(self, model, evaluator, max_images=None):
        """get_evaluator()'s evaluator on `model` (moved to the
        evaluator's device, in eval mode) through its head's decode."""
        model = model.to(evaluator.device).eval()
        return evaluator.evaluate(decode_forward(model),
                                  max_images=max_images)
