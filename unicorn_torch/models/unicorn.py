"""The unified Unicorn model and the detection / instance-segmentation
model YOLOXDet, PyTorch (port of unicorn_tpu/models/unicorn.py).

Unicorn: the backbone + PAFPN stage (`forward_backbone`, both run_fpn
modes), the interaction of two frames' stride-16 features in the "deform",
"full" or "conv" mode (`forward_interaction`; "conv" takes no position
embedding), the embedding upsample (`forward_upsample`), the unified head
(`forward_head`), the MOT detection forward (`forward_whole`) and, with
use_mask, the CondInst mask branch (`forward_mask_branch`, with the RAFT
up-mask under use_raft). YOLOXDet: PAFPN + detection head without the SOT
branch or priors, and with use_mask the controllers and the mask branch.
`remat` (False, True or "dw") rematerialises the ConvNeXt trunk's blocks
in training (models/blocks.py ConvNeXtBlock), and Swin's blocks whole under
any truthy value; ResNet-50 and CSPDarknet ignore it, and the head's
attention blocks are not rematerialised, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn as nn

from ..utils.profiling import spanned
from .blocks import init_weights
from .heads import UnicornHead
from .interaction import (Bottleneck1x1, ConvInteraction,
                          DeformableInteraction, FullAttentionInteraction,
                          PositionEmbeddingLearned, UpsampleEmbed)
from .mask_head import MaskBranch
from .pafpn import YOLOPAFPN

INTERACT_MODES = ("deform", "full", "conv")


class Unicorn(nn.Module):
    """Backbone + PAFPN + interaction + embedding + unified head (+ the mask
    branch with use_mask). Parameters are fp32, computed in `dtype` (the
    interaction and embedding stages in `interact_dtype`), and drawn from
    `generator` (flax's init distributions; a generator seeded with 0 when
    none is given). `msda_method` is the `method` the deformable
    interaction hands to ops.deform_attn.ms_deform_attn."""

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
        if interact_mode not in INTERACT_MODES:
            raise ValueError(interact_mode)
        if interact_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"interact_dtype {interact_dtype} is neither "
                             "float32 nor bfloat16")
        self.dtype = dtype
        self.interact_dtype = interact_dtype
        self.interact_mode = interact_mode
        self.backbone = YOLOPAFPN(
            depth=depth, width=width, in_channels=in_channels, act=act,
            backbone_name=backbone_name, dtype=dtype, exact_gelu=exact_gelu,
            remat=remat)
        mask_branch = MaskBranch(
            [int(c * width) for c in in_channels], use_raft=use_raft,
            up_rate=up_rate, dtype=dtype) if use_mask else None
        self.head = UnicornHead(
            num_classes=num_classes, width=width, in_channels=in_channels,
            act=act, sot_branch=True, use_attention=use_attention,
            n_layer_att=n_layer_att, unshared_obj=unshared_obj,
            unshared_reg=unshared_reg, fuse_method=fuse_method,
            learnable_fuse=learnable_fuse, exact_gelu=exact_gelu,
            with_mask=use_mask, mask_branch=mask_branch, dtype=dtype)
        idt = interact_dtype
        self.bottleneck = Bottleneck1x1(self.backbone.raw_channels[1],
                                        hidden_dim, dtype=idt)
        self.upsample_layer = UpsampleEmbed(embed_dim, hidden_dim, dtype=idt)
        if interact_mode == "conv":
            self.pos_emb = None
            self.transformer = ConvInteraction(hidden_dim, dtype=idt)
        else:
            self.pos_emb = PositionEmbeddingLearned(hidden_dim // 2, sz=40,
                                                    dtype=idt)
            self.transformer = (
                FullAttentionInteraction(hidden_dim, dtype=idt)
                if interact_mode == "full" else
                DeformableInteraction(hidden_dim, dtype=idt,
                                      msda_method=msda_method))
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

    @spanned("model.interaction")
    def forward_interaction(self, feat0, feat1):
        """Interact two frames' raw stride-16 features (B, C_backbone, H16,
        W16) -> the refined (B, hidden_dim, H16, W16) pair."""
        b, _, h, w = feat0.shape
        srcs = (self.bottleneck(feat0), self.bottleneck(feat1))
        if self.pos_emb is None:
            return self.transformer(srcs)
        pos = self.pos_emb(b, h, w)
        return self.transformer(srcs, (pos, pos))

    def forward_upsample(self, feat):
        """Stride-16 feature -> stride-8 embedding map (B, embed_dim, H8,
        W8)."""
        return self.upsample_layer(feat)

    @spanned("model.head")
    def forward_head(self, fpn_outs, priors):
        """The unified head. priors: per-level (B, 1, H, W) label maps."""
        return self.head(fpn_outs, priors)

    def forward_mask_branch(self, fpn_outs):
        """(mask_feats (B, 8, H8, W8), up_mask (B, 9*up_rate**2, H8, W8) or
        None, None) of the CondInst mask branch (use_mask)."""
        return self.head.mask_branch(fpn_outs)

    @spanned("model.forward")
    def forward_whole(self, imgs):
        """MOT detection forward: backbone + head with zero priors.
        Returns (raw_head_outputs, feat_s16)."""
        fpn_outs, feat_s16 = self.forward_backbone(imgs)
        priors = tuple(f.new_zeros((f.shape[0], 1) + tuple(f.shape[2:]))
                       for f in fpn_outs)
        return self.forward_head(fpn_outs, priors), feat_s16

    def forward(self, imgs):
        return self.forward_whole(imgs)


class YOLOXDet(nn.Module):
    """Detection / instance-segmentation model: PAFPN + detection head (no
    SOT branch, no prior fusion). With use_mask the head has the CondInst
    controllers and forward returns (head_raw, (mask_feats, up_mask,
    sem_logits)); else head_raw. As in the JAX model, the head's GELU is
    exact whatever exact_gelu says (that field reaches the backbone)."""

    def __init__(self, num_classes: int = 80, depth: float = 1.0,
                 width: float = 1.0,
                 in_channels: Sequence[int] = (192, 384, 768),
                 backbone_name: str = "convnext_tiny", act: str = "silu",
                 use_attention: bool = False, n_layer_att: int = 0,
                 use_mask: bool = False, sem_loss_on: bool = False,
                 exact_gelu: bool = True, remat: Any = False,
                 dtype=torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.backbone = YOLOPAFPN(
            depth=depth, width=width, in_channels=in_channels, act=act,
            backbone_name=backbone_name, dtype=dtype, exact_gelu=exact_gelu,
            remat=remat)
        mask_branch = MaskBranch(
            [int(c * width) for c in in_channels], sem_loss_on=sem_loss_on,
            num_classes=num_classes, dtype=dtype) if use_mask else None
        # no priors reach this head, so it has no fusion parameters (flax
        # creates beta_k only when priors are passed)
        self.head = UnicornHead(
            num_classes=num_classes, width=width, in_channels=in_channels,
            act=act, sot_branch=False, use_attention=use_attention,
            n_layer_att=n_layer_att, learnable_fuse=False,
            with_mask=use_mask, mask_branch=mask_branch, dtype=dtype)
        init_weights(self, generator if generator is not None
                     else torch.Generator().manual_seed(0))

    def forward(self, imgs):
        fpn_outs = self.backbone(imgs)
        head_raw = self.head(fpn_outs, None)
        if self.head.mask_branch is not None:
            return head_raw, self.head.mask_branch(fpn_outs)
        return head_raw
