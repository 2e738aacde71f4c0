"""The unified Unicorn model, PyTorch (port of unicorn_tpu/models/unicorn.py).

Ported: the backbone + PAFPN stage (`forward_backbone`, both run_fpn modes),
the deformable interaction of two frames' stride-16 features
(`forward_interaction`), the embedding upsample (`forward_upsample`), the
unified head (`forward_head`) and the MOT detection forward
(`forward_whole`). The "conv" and "full" interaction modes and the mask
branch are not ported yet: those constructor fields accept only their
defaults, and convert.from_flax reports the mask branch's parameters as not
ported.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn as nn

from .blocks import init_weights
from .heads import UnicornHead
from .interaction import (Bottleneck1x1, DeformableInteraction,
                          PositionEmbeddingLearned, UpsampleEmbed)
from .pafpn import YOLOPAFPN


def _not_ported(field, value):
    raise NotImplementedError(f"Unicorn({field}={value!r}) needs a module "
                              "that is not yet ported")


class Unicorn(nn.Module):
    """Backbone + PAFPN + interaction + embedding + unified head. Parameters
    are fp32, computed in `dtype` (the interaction and embedding stages in
    `interact_dtype`), and drawn from `generator` (flax's init
    distributions; a generator seeded with 0 when none is given).
    `msda_method` is the `method` the deformable interaction hands to
    ops.deform_attn.ms_deform_attn."""

    def __init__(self, num_classes: int = 8, depth: float = 1.0,
                 width: float = 1.0,
                 in_channels: Sequence[int] = (192, 384, 768),
                 backbone_name: str = "convnext_tiny", act: str = "silu",
                 interact_mode: str = "deform", embed_dim: int = 128,
                 hidden_dim: int = 256, use_attention: bool = True,
                 n_layer_att: int = 3, unshared_obj: bool = True,
                 unshared_reg: bool = True, fuse_method: str = "sum",
                 learnable_fuse: bool = True, use_mask: bool = False,
                 exact_gelu: bool = True, use_raft: bool = False,
                 up_rate: int = 8, remat: Any = False, dtype=torch.float32,
                 interact_dtype=torch.float32, msda_method: str = "auto",
                 generator: torch.Generator | None = None):
        super().__init__()
        for field, value, default in (
                ("interact_mode", interact_mode, "deform"),
                ("use_mask", use_mask, False), ("use_raft", use_raft, False),
                ("up_rate", up_rate, 8), ("remat", remat, False)):
            if value != default:
                _not_ported(field, value)
        if interact_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"interact_dtype {interact_dtype} is neither "
                             "float32 nor bfloat16")
        self.dtype = dtype
        self.interact_dtype = interact_dtype
        self.backbone = YOLOPAFPN(
            depth=depth, width=width, in_channels=in_channels, act=act,
            backbone_name=backbone_name, dtype=dtype, exact_gelu=exact_gelu)
        self.head = UnicornHead(
            num_classes=num_classes, width=width, in_channels=in_channels,
            act=act, sot_branch=True, use_attention=use_attention,
            n_layer_att=n_layer_att, unshared_obj=unshared_obj,
            unshared_reg=unshared_reg, fuse_method=fuse_method,
            learnable_fuse=learnable_fuse, exact_gelu=exact_gelu,
            dtype=dtype)
        idt = interact_dtype
        self.bottleneck = Bottleneck1x1(self.backbone.raw_channels[1],
                                        hidden_dim, dtype=idt)
        self.upsample_layer = UpsampleEmbed(embed_dim, hidden_dim, dtype=idt)
        self.pos_emb = PositionEmbeddingLearned(hidden_dim // 2, sz=40,
                                                dtype=idt)
        self.transformer = DeformableInteraction(hidden_dim, dtype=idt,
                                                 msda_method=msda_method)
        init_weights(self, generator if generator is not None
                     else torch.Generator().manual_seed(0))

    def forward_backbone(self, imgs, run_fpn: bool = True):
        """imgs (B, 3, H, W) -> (fpn_outs, feat_s16), or feat_s16 alone
        when run_fpn is False. feat_s16 is the raw stride-16 backbone
        feature the interaction uses."""
        if run_fpn:
            fpn_outs, base_outs = self.backbone(imgs, return_base_feat=True)
            return fpn_outs, base_outs[1]
        return self.backbone(imgs, run_fpn=False)[1]

    def forward_interaction(self, feat0, feat1):
        """Interact two frames' raw stride-16 features (B, C_backbone, H16,
        W16) -> the refined (B, hidden_dim, H16, W16) pair."""
        b, _, h, w = feat0.shape
        srcs = (self.bottleneck(feat0), self.bottleneck(feat1))
        pos = self.pos_emb(b, h, w)
        return self.transformer(srcs, (pos, pos))

    def forward_upsample(self, feat):
        """Stride-16 feature -> stride-8 embedding map (B, embed_dim, H8,
        W8)."""
        return self.upsample_layer(feat)

    def forward_head(self, fpn_outs, priors):
        """The unified head. priors: per-level (B, 1, H, W) label maps."""
        return self.head(fpn_outs, priors)

    def forward_whole(self, imgs):
        """MOT detection forward: backbone + head with zero priors.
        Returns (raw_head_outputs, feat_s16)."""
        fpn_outs, feat_s16 = self.forward_backbone(imgs)
        priors = tuple(f.new_zeros((f.shape[0], 1) + tuple(f.shape[2:]))
                       for f in fpn_outs)
        return self.head(fpn_outs, priors), feat_s16

    def forward(self, imgs):
        return self.forward_whole(imgs)
