"""MOTS-only ablation: the mask stage without its VOS group (mot_only) (the
port's copy of exps/default/unicorn_track_tiny_mots_only.py)."""
from .track_mask import ExpTrackMask


class Exp(ExpTrackMask):
    def __init__(self):
        super().__init__()
        self.exp_name = "unicorn_track_tiny_mots_only"
        self.mot_only = True
        self.pretrain_name = "unicorn_track_tiny"
