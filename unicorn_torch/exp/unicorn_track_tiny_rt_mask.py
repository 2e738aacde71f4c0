"""VOS+MOTS mask stage of the real-time setting, ConvNeXt-Tiny @ 640x1024 (the
port's copy of exps/default/unicorn_track_tiny_rt_mask.py)."""
from .track_mask import ExpTrackMask


class Exp(ExpTrackMask):
    def __init__(self):
        super().__init__()
        self.exp_name = "unicorn_track_tiny_rt_mask"
        self.input_size = (640, 1024)
        self.test_size = (640, 1024)
        self.pretrain_name = "unicorn_track_tiny_rt"
