"""Unified SOT-MOT baseline, ConvNeXt-Tiny @ 800x1280 (the port's copy of
exps/default/unicorn_track_tiny.py)."""
from .track import ExpTrack


class Exp(ExpTrack):
    def __init__(self):
        super().__init__()
        self.exp_name = "unicorn_track_tiny"
