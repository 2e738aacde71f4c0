"""Unified SOT+MOT experiment: the model, data, training and test fields
of unicorn_tpu/exp/track.py ExpTrack, get_model() building the port's
Unicorn (any of its interaction modes, `interact_mode`), the training
factories get_lr_fn / get_optimizer / get_train_step, the omni dataset and
its loader (get_dataset: the reference's on-disk mix under
get_unicorn_datadir(), or sub-datasets the caller passes;
get_data_loader), load_pretrained (detector -> tracker weight surgery), and
the evaluators: get_evaluator (MOT metrics, tools/track.py's) and
get_trainer_evaluator (COCO box AP over the COCO-format MOT val set)."""
from __future__ import annotations

import logging
import os

import torch

from ..core.checkpoint import load_checkpoint
from ..core.schedule import warm_cos_lr_fn
from ..core.train_state import default_wd_mask, make_optimizer
from ..core.train_step import make_uni_train_step
from ..data.datasets.bdd import BDDOmniDataset
from ..data.datasets.coco import COCODataset
from ..data.datasets.mot import MOTOmniDataset
from ..data.datasets.omni import OmniDataset, OmniDatasetPlus
from ..data.datasets.sot import COCOSOT, Got10k, Lasot, TrackingNet
from ..data.loader import UniLoader
from ..data.transforms import TrainTransformOmni, ValTransform
from ..evaluators.coco_evaluator import COCOEvaluator
from ..evaluators.mot_evaluator import MOTEvaluator
from ..models.unicorn import Unicorn
from .base import BaseExp
from .det import get_unicorn_datadir


class ExpTrack(BaseExp):
    def __init__(self):
        super().__init__()
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
        # backbone block remat (same numbers, less memory): False, True
        # or "dw", as ExpDet
        self.remat = False
        self.input_size = (800, 1280)
        # ---------------- dataloader config ---------------- #
        self.data_num_workers = 1
        self.multiscale_range = 2
        self.max_labels = 100
        # the COCO set under data_dir (None: <datadir>/coco), its train
        # split feeding COCOSOT (and the mask stage's COCO groups)
        self.data_dir = None
        self.train_ann = "instances_train2017.json"
        self.train_name = "train2017"
        # --------------- transform config ----------------- #
        # the mosaic fields are JAX's; no loader of this stage reads them
        self.mosaic_prob = -1.0
        self.mixup_prob = 1.0
        self.hsv_prob = 1.0
        self.flip_prob = 0.5
        self.degrees = 10.0
        self.translate = 0.1
        self.mosaic_scale = (0.1, 2)
        self.mixup_scale = (0.5, 1.5)
        self.shear = 2.0
        self.enable_mixup = True
        # --------------  training config --------------------- #
        self.seed = None
        self.output_dir = "./Unicorn_outputs"
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
        self.print_interval = 15
        self.debug_only = False
        self.eval_interval = 10
        self.samples_per_epoch = 200000
        self.always_l1 = True
        self.use_grad_acc = True
        self.grad_acc_step = 2
        self.bidirect = True
        self.train_mode = "alter"
        self.alter_step = 1
        self.mot_weight = 3
        self.scale_all_mot = True
        self.pretrain_name = "unicorn_det_convnext_tiny_800x1280"
        # -----------------  testing config ------------------ #
        self.test_size = (800, 1280)
        self.test_conf = 0.01
        self.nmsthre = 0.65
        self.test_ann = "test.json"
        self.test_name = "test"
        # the in-training eval's root (the reference's unicorn_track.py:109:
        # the MOT Challenge COCO-format val, BDD-trained exps too); None:
        # <datadir>/mot
        self.test_data_dir = None
        # -----------------  other config ------------------ #
        self.sot_only = False
        self.mot_only = False
        self.mot_test_name = "bdd100k"  # "bdd100k" or "motchallenge"

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

    def get_train_step(self, batch_size, mesh=None):
        """step(state, images (B, 2, 3, H, W), targets (B, 2, M, 6),
        task_ids (B,)) -> (state, loss_dict) at this experiment's input
        size and loss weights; `mesh` as make_uni_train_step's (a pod
        mesh's hierarchical gradient sum)."""
        del batch_size  # shapes are the batch's own
        return make_uni_train_step(
            self.input_size,
            mot_weight=float(self.mot_weight) if self.scale_all_mot else 1.0,
            bidirect=self.bidirect, use_l1=self.always_l1,
            num_classes=self.num_classes, mhs=self.mhs, mesh=mesh)

    # ---- weights, data, evaluation ----

    def load_pretrained(self, state_dict: dict) -> dict:
        """Detector -> tracker weight surgery on the port's state_dict names,
        from the port's checkpoint
        <cwd>/Unicorn_outputs/<pretrain_name>/latest:
        every tensor whose name and shape match is copied; `cls_preds` maps
        80 -> 8 classes by the class gather [0, 0, 2, 7, 5, 6, 3, 1] (or 80 ->
        1 by [0]) on its class axis (0); `obj_preds` / `reg_preds` are
        duplicated into the `*_sot` branches."""
        det = load_checkpoint(os.path.join(os.getcwd(), "Unicorn_outputs",
                                           self.pretrain_name))["model"]
        gather = [0, 0, 2, 7, 5, 6, 3, 1] if self.num_classes == 8 else [0]
        out = dict(state_dict)
        for k, v in det.items():
            if k not in out:
                continue
            if "cls_preds" in k and out[k].shape != v.shape:
                v = v[gather]
            if out[k].shape == v.shape:
                out[k] = v
        for k in out:
            for src, dst in (("obj_preds", "obj_preds_sot"),
                             ("reg_preds", "reg_preds_sot")):
                if dst in k:
                    src_k = k.replace(dst, src)
                    if src_k in det and det[src_k].shape == out[k].shape:
                        out[k] = det[src_k]
        return out

    def get_dataset(self, sot_datasets=None, mot_datasets=None):
        """The alternating OmniDatasetPlus over the SOT and MOT groups.
        A group left None is the reference's on-disk mix under
        get_unicorn_datadir() (`_sot_dataset_specs`, `_mot_dataset_specs`:
        SOT COCOSOT + LaSOT + GOT10K + TrackingNet at weights [1, 1, 1, 1];
        MOT BDD100K [1], or with mot_test_name "motchallenge" MOT17 +
        CrowdHuman + CityPersons + ETHZ [2, 6, 1, 1]); a dataset whose files
        are missing is skipped with a logged warning. Passed groups are
        lists of sub-datasets (each with pull_item_omni), weighted by their
        lengths. sot_only / mot_only drop a group before anything is
        built. With no dataset in either group it raises
        FileNotFoundError (naming the root), where JAX's loader would fail
        at its first draw."""
        sot_weights = mot_weights = None
        if self.mot_only:
            sot_datasets = []
        if self.sot_only:
            mot_datasets = []
        root = get_unicorn_datadir()
        if sot_datasets is None:
            sot_datasets, sot_weights = self._build_group(
                self._sot_dataset_specs(root))
        if mot_datasets is None:
            mot_datasets, mot_weights = self._build_group(
                self._mot_dataset_specs(root))
        sot = OmniDataset(sot_datasets, p_datasets=sot_weights,
                          samples_per_epoch=self.samples_per_epoch // 2) \
            if sot_datasets else None
        mot = OmniDataset(mot_datasets, p_datasets=mot_weights,
                          samples_per_epoch=self.samples_per_epoch // 2) \
            if mot_datasets else None
        if sot is None and mot is None:
            raise FileNotFoundError(
                f"no training dataset found under {root} (set "
                f"UNICORN_DATADIR, or pass in-memory sub-datasets)")
        return OmniDatasetPlus(sot, mot, self.samples_per_epoch,
                               mode=self.train_mode)

    def _sot_dataset_specs(self, root):
        """(name, weight, builder) triples of the reference's SOT mix under
        `root`."""
        def coco_sot():
            return COCOSOT(COCODataset(
                data_dir=self.data_dir or os.path.join(root, "coco"),
                json_file=self.train_ann, name=self.train_name,
                img_size=self.input_size))

        return [
            ("COCOSOT", 1, coco_sot),
            ("LaSOT", 1, lambda: Lasot(os.path.join(root, "LaSOT"))),
            ("GOT10K", 1,
             lambda: Got10k(os.path.join(root, "GOT10K", "train"))),
            ("TrackingNet", 1,
             lambda: TrackingNet(os.path.join(root, "TrackingNet"))),
        ]

    def _mot_dataset_specs(self, root):
        """(name, weight, builder) triples of the reference's MOT mix under
        `root`: BDD100K, or MOT17, CrowdHuman, CityPersons and ETHZ."""
        if self.mot_test_name == "bdd100k":
            return [("BDD100K", 1, lambda: BDDOmniDataset(
                os.path.join(root, "bdd100k"), "train"))]
        if self.mot_test_name == "motchallenge":
            return [
                ("MOT17", 2, lambda: MOTOmniDataset(
                    os.path.join(root, "mot"), "train_omni.json", "train")),
                ("CrowdHuman", 6, lambda: MOTOmniDataset(
                    os.path.join(root, "crowdhuman"), "train.json",
                    "CrowdHuman_train")),
                ("CityPersons", 1, lambda: MOTOmniDataset(
                    os.path.join(root, "Cityscapes"), "train.json", None,
                    img_root=os.path.join(root, "Cityscapes"))),
                ("ETHZ", 1, lambda: MOTOmniDataset(
                    os.path.join(root, "ETHZ"), "train.json", None,
                    img_root=os.path.join(root, "ETHZ"))),
            ]
        raise ValueError(f"Unsupported mot_test_name: {self.mot_test_name}")

    @staticmethod
    def _build_group(specs):
        """Instantiate (name, weight, builder) specs, skipping with a logged
        warning only the datasets whose files are missing or that are
        empty; any other error propagates."""
        log = logging.getLogger("unicorn_torch")
        datasets, weights = [], []
        for name, weight, build in specs:
            try:
                ds = build()
            except (FileNotFoundError, NotADirectoryError) as e:
                log.warning("training mix: %s not found (%s); skipped",
                            name, e)
                continue
            if len(ds) == 0:
                log.warning("training mix: %s is empty; skipped", name)
                continue
            datasets.append(ds)
            weights.append(weight)
        return datasets, (weights or None)

    def get_data_loader(self, batch_size):
        """UniLoader over get_dataset() with TrainTransformOmni, the task
        flipped every alter_step batches, seeded from `seed` (0 when None),
        data_num_workers threads."""
        return UniLoader(
            self.get_dataset(),
            TrainTransformOmni(max_labels=self.max_labels,
                               flip_prob=self.flip_prob,
                               hsv_prob=self.hsv_prob),
            batch_size, self.input_size, alter_every=self.alter_step,
            seed=self.seed or 0, workers=self.data_num_workers)

    def get_evaluator(self, batch_size=1, device="cuda") -> MOTEvaluator:
        """The MOT-metrics evaluator (tools/track.py's path; sequential per
        video, so batch_size is unused)."""
        return MOTEvaluator(exp=self, device=device)

    def get_trainer_evaluator(self, batch_size=1, device="cuda"
                              ) -> COCOEvaluator:
        """In-training box AP over the COCO-format MOT val set
        (test_data_dir, else <datadir>/mot; test_ann, test_name): the
        reference's uni trainer runs a COCOEvaluator on its MOT val set
        (unicorn_track.py:402-443)."""
        data_dir = self.test_data_dir or os.path.join(get_unicorn_datadir(),
                                                      "mot")
        ds = COCODataset(data_dir=data_dir, json_file=self.test_ann,
                         name=self.test_name, img_size=self.test_size,
                         preproc=ValTransform())
        return COCOEvaluator(ds, self.test_size, conf_thre=self.test_conf,
                             nms_thre=self.nmsthre,
                             num_classes=self.num_classes,
                             batch_size=batch_size, device=device)
