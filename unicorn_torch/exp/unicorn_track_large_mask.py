"""VOS+MOTS mask stage, ConvNeXt-Large @ 800x1280 (the port's copy of
exps/default/unicorn_track_large_mask.py)."""
from .track_mask import ExpTrackMask


class Exp(ExpTrackMask):
    def __init__(self):
        super().__init__()
        self.exp_name = "unicorn_track_large_mask"
        self.backbone_name = "convnext_large"
        self.in_channels = [384, 768, 1536]
        self.pretrain_name = "unicorn_track_large"
        self.remat = True  # the large trunk's activations need it to fit
