"""Instance-segmentation experiment: the fields of
unicorn_tpu/exp/det_mask.py ExpDetMask, get_model() building the port's
YOLOXDet with the CondInst controllers and mask branch, and
get_inst_forward(). Its loader, evaluator, optimizer (the mask-only
masking), train step and `load_pretrained` are not ported yet."""
from __future__ import annotations

import torch

from ..drivers.inst import InstForward, make_inst_forward
from ..models.unicorn import YOLOXDet
from .det import ExpDet


class ExpDetMask(ExpDet):
    def __init__(self):
        super().__init__()
        self.task = "inst"
        self.exp_name = "unicorn_inst"
        self.train_mask_only = True
        self.d_rate = 4
        self.pretrain_name = "unicorn_det_convnext_tiny_800x1280"

    def get_model(self, generator: torch.Generator | None = None) -> YOLOXDet:
        return YOLOXDet(**self._model_fields(), use_mask=True,
                        generator=generator)

    def get_inst_forward(self, model: YOLOXDet,
                         device="cuda") -> InstForward:
        """decode + NMS + CondInst mask decode at the test thresholds, on
        `device` (the card unless the caller asks for the CPU)."""
        return make_inst_forward(
            model, num_classes=self.num_classes, conf_thre=self.test_conf,
            nms_thre=self.nmsthre, use_raft=getattr(self, "use_raft", False),
            up_rate=getattr(self, "up_rate", 8 // self.d_rate),
            device=device)
