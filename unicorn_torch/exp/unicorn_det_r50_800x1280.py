"""COCO detection pretraining, ResNet-50 @ 800x1280 (the port's copy of
exps/default/unicorn_det_r50_800x1280.py)."""
from .det import ExpDet


class Exp(ExpDet):
    def __init__(self):
        super().__init__()
        self.exp_name = "unicorn_det_r50_800x1280"
        self.backbone_name = "resnet50"
        self.in_channels = [512, 1024, 2048]
        self.width = 0.5
        self.input_size = (800, 1280)
        self.test_size = (800, 1280)
