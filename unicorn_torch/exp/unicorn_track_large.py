"""Unified SOT-MOT, ConvNeXt-Large @ 800x1280 (the port's copy of
exps/default/unicorn_track_large.py): starts from the large detector's
checkpoint."""
from .track import ExpTrack


class Exp(ExpTrack):
    def __init__(self):
        super().__init__()
        self.exp_name = "unicorn_track_large"
        self.backbone_name = "convnext_large"
        self.in_channels = [384, 768, 1536]
        self.pretrain_name = "unicorn_det_convnext_large_800x1280"
        self.remat = True  # the large trunk's activations need it to fit
