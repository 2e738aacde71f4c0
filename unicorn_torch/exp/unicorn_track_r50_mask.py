"""VOS+MOTS mask stage, ResNet-50 @ 800x1280 (the port's copy of
exps/default/unicorn_track_r50_mask.py)."""
from .track_mask import ExpTrackMask


class Exp(ExpTrackMask):
    def __init__(self):
        super().__init__()
        self.exp_name = "unicorn_track_r50_mask"
        self.backbone_name = "resnet50"
        self.in_channels = [512, 1024, 2048]
        self.width = 0.5
        self.pretrain_name = "unicorn_track_r50"
