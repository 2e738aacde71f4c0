"""VOS+MOTS mask stage, ConvNeXt-Tiny @ 800x1280 (the port's copy of
exps/default/unicorn_track_tiny_mask.py)."""
from .track_mask import ExpTrackMask


class Exp(ExpTrackMask):
    def __init__(self):
        super().__init__()
        self.exp_name = "unicorn_track_tiny_mask"
        self.pretrain_name = "unicorn_track_tiny"
