"""COCO detection pretraining, ConvNeXt-Large @ 800x1280 (the port's copy of
exps/default/unicorn_det_convnext_large_800x1280.py)."""
from .det import ExpDet


class Exp(ExpDet):
    def __init__(self):
        super().__init__()
        self.exp_name = "unicorn_det_convnext_large_800x1280"
        self.backbone_name = "convnext_large"
        self.in_channels = [384, 768, 1536]
        self.input_size = (800, 1280)
        self.test_size = (800, 1280)
        self.remat = True  # the large trunk's activations need it to fit
