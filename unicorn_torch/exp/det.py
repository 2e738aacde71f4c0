"""Detection experiment: the model and test fields of
unicorn_tpu/exp/det.py ExpDet, and get_model() building the port's
YOLOXDet. Its loader, evaluator, optimizer and train step are not ported
yet."""
from __future__ import annotations

import torch

from ..models.unicorn import YOLOXDet


class ExpDet:
    def __init__(self):
        self.task = "det"
        self.exp_name = "unicorn_det"
        # ---------------- model config ---------------- #
        self.num_classes = 80
        self.depth = 1.0
        self.width = 1.0
        self.act = "silu"
        self.backbone_name = "convnext_tiny"
        self.in_channels = [192, 384, 768]
        self.use_attention = True
        self.n_layer_att = 3
        self.bf16 = True
        # backbone block remat is not ported yet (same numbers, less memory)
        self.remat = False
        self.input_size = (640, 640)
        # -----------------  testing config ------------------ #
        self.test_size = (640, 640)
        self.test_conf = 0.01
        self.nmsthre = 0.65

    def _model_fields(self) -> dict:
        return dict(
            num_classes=self.num_classes, depth=self.depth, width=self.width,
            in_channels=tuple(self.in_channels),
            backbone_name=self.backbone_name, act=self.act,
            use_attention=self.use_attention, n_layer_att=self.n_layer_att,
            remat=self.remat,
            dtype=torch.bfloat16 if self.bf16 else torch.float32)

    def get_model(self, generator: torch.Generator | None = None) -> YOLOXDet:
        """The YOLOXDet of this experiment, on the CPU, parameters drawn
        from `generator` (seed 0 when None)."""
        return YOLOXDet(**self._model_fields(), generator=generator)
