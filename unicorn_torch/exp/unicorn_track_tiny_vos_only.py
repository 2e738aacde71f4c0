"""VOS-only ablation: the mask stage without its MOTS group (sot_only) (the
port's copy of exps/default/unicorn_track_tiny_vos_only.py)."""
from .track_mask import ExpTrackMask


class Exp(ExpTrackMask):
    def __init__(self):
        super().__init__()
        self.exp_name = "unicorn_track_tiny_vos_only"
        self.sot_only = True
        self.pretrain_name = "unicorn_track_tiny"
