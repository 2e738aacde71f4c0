"""YOLO PAFPN neck over a ConvNeXt, Swin, ResNet-50 or CSPDarknet backbone,
PyTorch (port of unicorn_tpu/models/pafpn.py). forward returns (pan_out2,
pan_out1, pan_out0) at strides (8, 16, 32), and optionally the raw backbone
features."""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..utils.profiling import span
from .blocks import BaseConv, CSPLayer, DWConv, upsample_nearest_2x
from .convnext import (CONVNEXT_OUT_CHANNELS, convnext_base, convnext_large,
                       convnext_tiny)
from .csp_darknet import CSPDarknet
from .resnet import RESNET_OUT_CHANNELS, ResNet50
from .swin import SWIN_BUILDERS, SWIN_OUT_CHANNELS


def build_backbone(name: str, depth: float = 1.0, width: float = 1.0,
                   dtype=torch.float32, exact_gelu: bool = True, remat=False):
    """(module, raw stride-8/16/32 channel counts): ConvNeXt or Swin (their
    blocks rematerialised under `remat`; any swin* name the table lacks is
    Swin-Tiny), ResNet-50 or CSPDarknet (at the model's depth and width);
    remat does not apply to the last two, as in the JAX package."""
    if name.startswith("convnext"):
        fn = {
            "convnext": convnext_tiny,
            "convnext_tiny": convnext_tiny,
            "convnext_base": convnext_base,
            "convnext_large": convnext_large,
        }[name]
        return (fn(dtype=dtype, exact_gelu=exact_gelu, remat=remat),
                CONVNEXT_OUT_CHANNELS[name])
    if name == "csp_darknet":
        ch = (int(256 * width), int(512 * width), int(1024 * width))
        return CSPDarknet(dep_mul=depth, wid_mul=width, dtype=dtype), ch
    if name.startswith("swin"):
        key = name if name in SWIN_BUILDERS else "swin_tiny"
        return (SWIN_BUILDERS[key](dtype=dtype, remat=remat),
                SWIN_OUT_CHANNELS[key])
    if name == "resnet50":
        return ResNet50(dtype=dtype), RESNET_OUT_CHANNELS[name]
    raise ValueError(f"unsupported backbone: {name}")


class YOLOPAFPN(nn.Module):
    def __init__(self, depth: float = 1.0, width: float = 1.0,
                 in_channels: Sequence[int] = (256, 512, 1024),
                 depthwise: bool = False, act: str = "silu",
                 backbone_name: str = "convnext_tiny", dtype=torch.float32,
                 exact_gelu: bool = True, remat=False):
        super().__init__()
        conv = DWConv if depthwise else BaseConv
        c0, c1, c2 = [int(c * width) for c in in_channels]
        kw = dict(act=act, dtype=dtype)
        self.backbone, raw = build_backbone(backbone_name, depth, width,
                                            dtype, exact_gelu, remat)
        self.raw_channels = raw   # of the backbone's stride-8/16/32 features
        self.adjust = raw != (c0, c1, c2)
        if self.adjust:
            self.adjust2 = BaseConv(raw[0], c0, 1, 1, **kw)
            self.adjust1 = BaseConv(raw[1], c1, 1, 1, **kw)
            self.adjust0 = BaseConv(raw[2], c2, 1, 1, **kw)
        n = round(3 * depth)
        csp = dict(n=n, shortcut=False, depthwise=depthwise, **kw)
        self.lateral_conv0 = BaseConv(c2, c1, 1, 1, **kw)
        self.C3_p4 = CSPLayer(2 * c1, c1, **csp)
        self.reduce_conv1 = BaseConv(c1, c0, 1, 1, **kw)
        self.C3_p3 = CSPLayer(2 * c0, c0, **csp)
        self.bu_conv2 = conv(c0, c0, 3, 2, **kw)
        self.C3_n3 = CSPLayer(2 * c0, c1, **csp)
        self.bu_conv1 = conv(c1, c1, 3, 2, **kw)
        self.C3_n4 = CSPLayer(2 * c1, c2, **csp)

    def forward(self, x, return_base_feat: bool = False, run_fpn: bool = True):
        with span("model.trunk"):
            x2, x1, x0 = self.backbone(x)  # strides 8, 16, 32
        if not run_fpn:
            return (x2, x1, x0)
        with span("model.neck"):
            outputs = self._neck(x2, x1, x0)
        if return_base_feat:
            return outputs, (x2, x1, x0)
        return outputs

    def _neck(self, x2, x1, x0):
        if self.adjust:
            x2_adj, x1_adj, x0_adj = (self.adjust2(x2), self.adjust1(x1),
                                      self.adjust0(x0))
        else:
            x2_adj, x1_adj, x0_adj = x2, x1, x0
        # top-down
        fpn_out0 = self.lateral_conv0(x0_adj)
        f_out0 = self.C3_p4(torch.cat([upsample_nearest_2x(fpn_out0), x1_adj], 1))
        fpn_out1 = self.reduce_conv1(f_out0)
        pan_out2 = self.C3_p3(torch.cat([upsample_nearest_2x(fpn_out1), x2_adj], 1))
        # bottom-up
        p_out1 = torch.cat([self.bu_conv2(pan_out2), fpn_out1], 1)
        pan_out1 = self.C3_n3(p_out1)
        p_out0 = torch.cat([self.bu_conv1(pan_out1), fpn_out0], 1)
        pan_out0 = self.C3_n4(p_out0)
        return (pan_out2, pan_out1, pan_out0)
