"""CondInst mask branch, PyTorch (port of unicorn_tpu/models/mask_head.py).

MaskBranch fuses the stride-8/16/32 FPN maps into the 8-channel mask
features, with the optional RAFT up-mask layer and the optional semantic
head. Module names follow the reference torch MaskBranch, which the
reference keeps under the head (state_dict `head.mask_branch.*`):
`refine.{0,1,2}`, `tower.{0..3}` and the 1x1 `tower.4`, `up_mask_layer.{0,2}`,
`seg_head.{0,1}`, `logits`; each conv block is (conv, norm) at `.0`, `.1`.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.dynamic_conv import (MASK_CHANNELS, aligned_bilinear,
                                compute_locations, convex_upsample,
                                dynamic_mask_logits)
from .blocks import Conv2d, GroupNorm32
from .heads import PRIOR_BIAS


class ConvBlock(nn.Sequential):
    """3x3 conv (no bias) -> GroupNorm -> ReLU."""

    def __init__(self, in_ch: int, channels: int, dtype=torch.float32):
        super().__init__(Conv2d(in_ch, channels, 3, padding=1, bias=False,
                                dtype=dtype),
                         GroupNorm32(channels, dtype=dtype))

    def forward(self, x):
        return F.relu(self[1](self[0](x)))


class MaskBranch(nn.Module):
    """in_channels: the three FPN maps' channels. forward returns
    (mask_feats (B, 8, H8, W8), up_mask (B, 9*R*R, H8, W8) or None,
    sem_logits (B, num_classes, H8, W8) or None)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int =
                 MASK_CHANNELS, channels: int = 128, num_convs: int = 4,
                 use_raft: bool = False, up_rate: int = 8,
                 sem_loss_on: bool = False, num_classes: int = 80,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.refine = nn.ModuleList([ConvBlock(c, channels, dtype)
                                     for c in in_channels])
        self.tower = nn.Sequential(
            *[ConvBlock(channels, channels, dtype) for _ in range(num_convs)],
            Conv2d(channels, max(out_channels, 1), 1, dtype=dtype))
        self.up_mask_layer = nn.Sequential(
            Conv2d(channels, channels, 3, padding=1, dtype=dtype), nn.ReLU(),
            Conv2d(channels, up_rate * up_rate * 9, 1, dtype=dtype)) \
            if use_raft else None
        if sem_loss_on:
            self.seg_head = nn.Sequential(
                ConvBlock(in_channels[0], channels, dtype),
                ConvBlock(channels, channels, dtype))
            self.logits = Conv2d(channels, num_classes, 1, dtype=dtype)
        else:
            self.seg_head = self.logits = None

    def _init_extra(self, generator):
        if self.logits is not None:
            with torch.no_grad():
                self.logits.bias.fill_(PRIOR_BIAS)

    def forward(self, fpn_feats):
        p3, p4, p5 = fpn_feats
        x = self.refine[0](p3)
        for refine, p in zip(self.refine[1:], (p4, p5)):
            xp = refine(p)
            # upsampled in fp32, cast back to the branch's dtype
            up = aligned_bilinear(xp.float(), x.shape[2] // xp.shape[2])
            x = x + up.to(x.dtype)
        mask_feats = self.tower(x)
        # the RAFT up-mask is computed from the fused refine output, not
        # from the tower
        up_mask = (self.up_mask_layer(x) if self.up_mask_layer is not None
                   else None)
        sem_logits = (self.logits(self.seg_head(p3))
                      if self.seg_head is not None else None)
        return mask_feats, up_mask, sem_logits


def anchor_locations_and_levels(hw_list, strides, device=None):
    """Per-anchor image-coordinate centres (A, 2) and FPN level ids (A,)
    int32, in the order of the head's flattened outputs."""
    locs, lvls = [], []
    for lvl, ((h, w), s) in enumerate(zip(hw_list, strides)):
        locs.append(compute_locations(h, w, s, device))
        lvls.append(torch.full((h * w,), lvl, dtype=torch.int32,
                               device=device))
    return torch.cat(locs), torch.cat(lvls)


def instance_mask_probs(mask_feats, up_mask, flat, rows, anchors, strides,
                        use_raft: bool, up_rate: int):
    """The CondInst mask decode of N instances -> sigmoid scores
    (N, H/4, W/4). Instance n runs the controllers of anchor anchors[n] in
    head batch row rows[n] (an int: the same row for all) on the image's
    mask features (1, 8, H/8, W/8); stride 8 -> 4 by RAFT convex
    upsampling (use_raft, with the up-mask) or aligned_bilinear x2.

    For S images at once, anchors and rows are (S, N) and mask_feats /
    up_mask (S, ...): image s decodes its N instances on its own maps ->
    (S, N, H/4, W/4)."""
    locs, lvls = anchor_locations_and_levels(flat["hw"], strides,
                                             anchors.device)
    anchors = anchors.long()
    if anchors.dim() == 1:
        mask_feats = mask_feats[0]
        up_mask = None if up_mask is None else up_mask[0]
    logits = dynamic_mask_logits(mask_feats, flat["ctrl"][rows, anchors],
                                 locs[anchors], lvls[anchors])
    if use_raft and up_mask is not None:
        m = convex_upsample(logits, up_mask, up_rate)
    else:
        m = aligned_bilinear(logits, 2)                 # stride 8 -> 4
    return torch.sigmoid(m)
