"""COCO instance-seg stage (CondInst branch only), ConvNeXt-Tiny @ 800x1280
(the port's copy of exps/default/unicorn_inst_convnext_tiny_800x1280.py)."""
from .det_mask import ExpDetMask


class Exp(ExpDetMask):
    def __init__(self):
        super().__init__()
        self.exp_name = "unicorn_inst_convnext_tiny_800x1280"
        self.input_size = (800, 1280)
        self.test_size = (800, 1280)
