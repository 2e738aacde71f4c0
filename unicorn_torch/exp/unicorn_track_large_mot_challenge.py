"""Unified SOT-MOT on the MOT-Challenge group (1 class, no mhs), ConvNeXt-Large
@ 800x1280 (the port's copy of
exps/default/unicorn_track_large_mot_challenge.py)."""
from .track import ExpTrack


class Exp(ExpTrack):
    def __init__(self):
        super().__init__()
        self.exp_name = "unicorn_track_large_mot_challenge"
        self.backbone_name = "convnext_large"
        self.in_channels = [384, 768, 1536]
        self.pretrain_name = "unicorn_det_convnext_large_800x1280"
        self.mot_test_name = "motchallenge"
        self.num_classes = 1
        self.mhs = False
        self.remat = True  # the large trunk's activations need it to fit
