"""COCO detection pretraining, ConvNeXt-Tiny @ 800x1280 (the port's copy of
exps/default/unicorn_det_convnext_tiny_800x1280.py): the stage whose
checkpoint unicorn_track_tiny's load_pretrained reads."""
from .det import ExpDet


class Exp(ExpDet):
    def __init__(self):
        super().__init__()
        self.exp_name = "unicorn_det_convnext_tiny_800x1280"
        self.input_size = (800, 1280)
        self.test_size = (800, 1280)
