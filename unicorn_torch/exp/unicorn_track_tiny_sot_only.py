"""SOT-only ablation: ExpTrack.get_dataset builds no MOT group (the port's copy
of exps/default/unicorn_track_tiny_sot_only.py)."""
from .track import ExpTrack


class Exp(ExpTrack):
    def __init__(self):
        super().__init__()
        self.exp_name = "unicorn_track_tiny_sot_only"
        self.sot_only = True
        self.train_mode = "alter"
