"""CSPDarknet backbone, PyTorch (port of unicorn_tpu/models/csp_darknet.py).

Returns the stride-8/16/32 maps (dark3, dark4, dark5). Module names follow
the reference torch CSPDarknet (YOLOX darknet.py): `stem` (Focus), then
`dark2` ... `dark5`, each an nn.Sequential of a stride-2 conv and its CSP
stage (dark5 with an SPPBottleneck between the two).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .blocks import BaseConv, CSPLayer, DWConv, Focus, SPPBottleneck


class CSPDarknet(nn.Module):
    def __init__(self, dep_mul: float = 1.0, wid_mul: float = 1.0,
                 depthwise: bool = False, act: str = "silu",
                 dtype=torch.float32):
        super().__init__()
        conv = DWConv if depthwise else BaseConv
        c = int(wid_mul * 64)
        d = max(round(dep_mul * 3), 1)
        kw = dict(act=act, dtype=dtype)
        csp = dict(depthwise=depthwise, **kw)
        self.stem = Focus(3, c, ksize=3, **kw)
        self.dark2 = nn.Sequential(conv(c, 2 * c, 3, 2, **kw),
                                   CSPLayer(2 * c, 2 * c, n=d, **csp))
        self.dark3 = nn.Sequential(conv(2 * c, 4 * c, 3, 2, **kw),
                                   CSPLayer(4 * c, 4 * c, n=3 * d, **csp))
        self.dark4 = nn.Sequential(conv(4 * c, 8 * c, 3, 2, **kw),
                                   CSPLayer(8 * c, 8 * c, n=3 * d, **csp))
        self.dark5 = nn.Sequential(
            conv(8 * c, 16 * c, 3, 2, **kw),
            SPPBottleneck(16 * c, 16 * c, **kw),
            CSPLayer(16 * c, 16 * c, n=d, shortcut=False, **csp))

    def forward(self, x):
        x = self.dark2(self.stem(x))
        c3 = self.dark3(x)
        c4 = self.dark4(c3)
        return c3, c4, self.dark5(c4)
