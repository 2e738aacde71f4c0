"""Unified VOS+MOTS experiment (the mask stage): the fields of
unicorn_tpu/exp/track_mask.py ExpTrackMask, get_model() building the
port's Unicorn with the CondInst controllers, the mask branch and its RAFT
up-mask layer, and the training factories get_optimizer (AdamW with
accumulation; with train_mask_only only the controllers and the mask branch
train) and get_train_step, and the VOS + MOTS loader (UniMaskLoader with
TrainTransformIns) over the reference's on-disk mask-stage mix
(`_vos_dataset_specs`, `_mots_dataset_specs`); it inherits ExpTrack's
get_dataset and load_pretrained (the uni checkpoint into the mask
model)."""
from __future__ import annotations

import os

from ..core.train_step import make_uni_mask_train_step
from ..data.datasets.bdd import BDDOmniMOTSDataset
from ..data.datasets.vos import (COCOMOTSDataset, DAVISTrainDataset,
                                 MOTSVideoDataset, SaliencyDataset,
                                 YoutubeVOSDataset)
from ..data.loader import UniMaskLoader
from ..data.transforms import TrainTransformIns
from .det_mask import mask_only
from .track import ExpTrack


class ExpTrackMask(ExpTrack):
    def __init__(self):
        super().__init__()
        self.exp_name = "unicorn_track_mask"
        self.use_raft = True
        self.d_rate = 2
        self.up_rate = 8 // self.d_rate
        self.ema = False
        self.train_mask_only = True
        self.max_epoch = 5
        self.samples_per_epoch = 100000
        self.mhs = False
        self.pretrain_name = "unicorn_track_tiny"

    def _mask_fields(self) -> dict:
        return dict(use_mask=True, use_raft=self.use_raft,
                    up_rate=self.up_rate)

    def get_optimizer(self, batch_size, iters_per_epoch=12500):
        """The parent's update rule, mask-only with train_mask_only."""
        return mask_only(super().get_optimizer(batch_size, iters_per_epoch),
                         self.train_mask_only)

    def get_train_step(self, batch_size):
        """step(state, images (B, 2, 3, H, W), targets (B, 2, M, 6),
        task_ids (B,) 1 = VOS / 2 = MOTS, masks (B, 2, M, H / d_rate,
        W / d_rate)) -> (state, loss_dict)."""
        del batch_size  # shapes are the batch's own
        return make_uni_mask_train_step(
            self.input_size,
            mot_weight=float(self.mot_weight) if self.scale_all_mot else 1.0,
            bidirect=self.bidirect, use_l1=self.always_l1,
            up_rate=self.up_rate, max_inst=int(getattr(self, "max_inst", 24)))

    def _vos_dataset_specs(self, root):
        """(name, weight, builder) of the VOS group (task 1): COCO
        instances, saliency, DAVIS and YouTube-VOS at weights [1, 1, 1,
        1]."""
        return [
            ("COCO-inst", 1, lambda: COCOMOTSDataset(
                self.data_dir or os.path.join(root, "coco"),
                json_file=self.train_ann, name=self.train_name)),
            ("Saliency", 1,
             lambda: SaliencyDataset(os.path.join(root, "saliency"))),
            ("DAVIS", 1,
             lambda: DAVISTrainDataset(os.path.join(root, "DAVIS"))),
            ("YouTubeVOS", 1,
             lambda: YoutubeVOSDataset(os.path.join(root, "ytbvos18"))),
        ]

    def _mots_dataset_specs(self, root):
        """(name, weight, builder) of the MOTS group (task 2): BDD100K's
        seg_track [1], or with mot_test_name "motchallenge" the COCO
        persons and MOTS-Challenge [1, 1]."""
        if self.mot_test_name == "bdd100k":
            return [("BDD-MOTS", 1, lambda: BDDOmniMOTSDataset(
                os.path.join(root, "bdd100k"), "train"))]
        if self.mot_test_name == "motchallenge":
            return [
                ("COCO-person", 1, lambda: COCOMOTSDataset(
                    self.data_dir or os.path.join(root, "coco"),
                    json_file=self.train_ann, name=self.train_name,
                    person_only=True)),
                ("MOTS-Challenge", 1, lambda: MOTSVideoDataset(
                    os.path.join(root, "MOTS"))),
            ]
        raise ValueError(f"Unsupported mot_test_name: {self.mot_test_name}")

    def _sot_dataset_specs(self, root):
        return self._vos_dataset_specs(root)

    def _mot_dataset_specs(self, root):
        return self._mots_dataset_specs(root)

    def get_data_loader(self, batch_size):
        """UniMaskLoader over get_dataset() (ExpTrack's, whose groups here
        are VOS, task 1, and MOTS, task 2, of frames (img, res, masks)) with
        TrainTransformIns (masks at 1 / d_rate), seeded from `seed` (0 when
        None)."""
        return UniMaskLoader(
            self.get_dataset(),
            TrainTransformIns(max_labels=self.max_labels,
                              flip_prob=self.flip_prob,
                              hsv_prob=self.hsv_prob, d_rate=self.d_rate),
            batch_size, self.input_size, alter_every=self.alter_step,
            seed=self.seed or 0, workers=self.data_num_workers)
