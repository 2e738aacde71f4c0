"""Real-time setting, ConvNeXt-Tiny @ 640x1024 (the port's copy of
exps/default/unicorn_track_tiny_rt.py)."""
from .track import ExpTrack


class Exp(ExpTrack):
    def __init__(self):
        super().__init__()
        self.exp_name = "unicorn_track_tiny_rt"
        self.input_size = (640, 1024)
        self.test_size = (640, 1024)
        self.pretrain_name = "unicorn_det_convnext_tiny_800x1280"
