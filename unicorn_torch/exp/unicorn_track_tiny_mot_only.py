"""MOT-only ablation: ExpTrack.get_dataset builds no SOT group (the port's copy
of exps/default/unicorn_track_tiny_mot_only.py)."""
from .track import ExpTrack


class Exp(ExpTrack):
    def __init__(self):
        super().__init__()
        self.exp_name = "unicorn_track_tiny_mot_only"
        self.mot_only = True
