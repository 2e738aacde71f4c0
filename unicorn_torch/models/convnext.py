"""ConvNeXt backbone, PyTorch (port of unicorn_tpu/models/convnext.py).

Returns the stride-8/16/32 features of stages 1..3, each through its output
LayerNorm. Module names follow the reference torch ConvNeXt
(downsample_layers / stages / norm{i}). `remat` (False, True or "dw")
rematerialises the stage blocks in training, as ConvNeXtBlock describes.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .blocks import CL, Conv2d, ConvNeXtBlock, LayerNorm32


def space_to_depth_4x4(x):
    """(B, H, W, C) -> (B, H/4, W/4, 16C), patch-major (dy, dx, c) order:
    the contraction order of a stride-4 4x4 conv kernel (kh, kw, cin)."""
    b, h, w, c = x.shape
    xp = x.reshape(b, h // 4, 4, w // 4, 4, c)
    return xp.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 4, w // 4, 16 * c)


class PatchEmbed4x4(nn.Module):
    """The ConvNeXt stem (4x4/4 conv) as space-to-depth + matmul. Takes an
    NCHW image with `in_chans` channels, or one already packed by
    `space_to_depth_4x4` (16 * in_chans channels, NCHW view of the packed
    NHWC array). weight (features, in_chans, 4, 4) as the reference conv."""

    lecun = True  # init_weights: lecun_normal weight, zero bias

    def __init__(self, features: int, in_chans: int = 3, dtype=torch.float32):
        super().__init__()
        self.in_chans = in_chans
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_chans, 4, 4))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        cin, dt = self.in_chans, self.dtype
        xn = x.permute(0, 2, 3, 1)
        if xn.shape[-1] == cin:
            xn = space_to_depth_4x4(xn)
        if xn.shape[-1] != 16 * cin:
            raise ValueError(f"PatchEmbed4x4 expects {cin} or {16 * cin} "
                             f"channels, got {tuple(x.shape)}")
        w = self.weight.permute(2, 3, 1, 0).reshape(16 * cin, -1)
        y = xn.to(dt) @ w.to(dt)
        return (y + self.bias.to(dt)).permute(0, 3, 1, 2)


REMAT_MODES = (False, True, "dw")


class ConvNeXt(nn.Module):
    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 layer_scale_init_value: float = 1e-6, dtype=torch.float32,
                 exact_gelu: bool = True, in_chans: int = 3,
                 remat=False):
        super().__init__()
        if remat not in REMAT_MODES:
            raise ValueError(f"remat {remat!r} is none of {REMAT_MODES}")
        self.remat = remat
        self.downsample_layers = nn.ModuleList([nn.Sequential(
            PatchEmbed4x4(dims[0], in_chans, dtype=dtype),
            LayerNorm32(dims[0], dtype=dtype, channels_first=True,
                        fast_norms=True))])
        for i in range(1, 4):
            self.downsample_layers.append(nn.Sequential(
                LayerNorm32(dims[i - 1], dtype=dtype, channels_first=True,
                            fast_norms=True),
                Conv2d(dims[i - 1], dims[i], 2, 2, dtype=dtype, same=True)))
        self.stages = nn.ModuleList([
            nn.Sequential(*[
                ConvNeXtBlock(dims[i], layer_scale_init_value, dtype=dtype,
                              exact_gelu=exact_gelu)
                for _ in range(depths[i])])
            for i in range(4)])
        for i in range(1, 4):
            self.add_module(f"norm{i}", LayerNorm32(
                dims[i], dtype=dtype, channels_first=True, fast_norms=True))
        for stage in self.stages:
            for block in stage:
                block.remat = remat

    def forward(self, x):
        outs = []
        for i in range(4):
            x = self.stages[i](self.downsample_layers[i](x))
            if i >= 1:
                y = getattr(self, f"norm{i}")(x)
                outs.append(y.contiguous(memory_format=CL))
        return tuple(outs)  # strides 8, 16, 32


def convnext_tiny(dtype=torch.float32, exact_gelu=True, remat=False):
    return ConvNeXt(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768),
                    dtype=dtype, exact_gelu=exact_gelu, remat=remat)


def convnext_base(dtype=torch.float32, exact_gelu=True, remat=False):
    return ConvNeXt(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024),
                    dtype=dtype, exact_gelu=exact_gelu, remat=remat)


def convnext_large(dtype=torch.float32, exact_gelu=True, remat=False):
    return ConvNeXt(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536),
                    dtype=dtype, exact_gelu=exact_gelu, remat=remat)


CONVNEXT_OUT_CHANNELS = {
    "convnext_tiny": (192, 384, 768),
    "convnext": (192, 384, 768),
    "convnext_base": (256, 512, 1024),
    "convnext_large": (384, 768, 1536),
}
