"""Unified VOS+MOTS experiment (the mask stage): the fields of
unicorn_tpu/exp/track_mask.py ExpTrackMask and get_model() building the
port's Unicorn with the CondInst controllers, the mask branch and its RAFT
up-mask layer. Its loader, its optimizer (only the controllers and the
mask branch train), its train step and `load_pretrained` are not ported
yet: get_optimizer and get_train_step raise rather than hand out ExpTrack's
uni-stage ones."""
from __future__ import annotations

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
        raise NotImplementedError("the mask stage's optimizer (controllers "
                                  "and mask branch only) is not yet ported")

    def get_train_step(self, batch_size):
        raise NotImplementedError("the mask stage's train step "
                                  "(make_uni_mask_train_step) is not yet "
                                  "ported")
