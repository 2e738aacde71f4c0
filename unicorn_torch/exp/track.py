"""Unified SOT+MOT experiment: the model and test fields of
unicorn_tpu/exp/track.py ExpTrack, and get_model() building the port's
Unicorn."""
from __future__ import annotations

import torch

from ..models.unicorn import Unicorn


class ExpTrack:
    def __init__(self):
        self.task = "uni"
        self.exp_name = "unicorn_track"
        # ---------------- model config ---------------- #
        self.num_classes = 8
        self.depth = 1.0
        self.width = 1.0
        self.act = "silu"
        self.backbone_name = "convnext_tiny"
        self.in_channels = [192, 384, 768]
        self.embed_dim = 128
        self.interact_mode = "deform"
        self.use_attention = True
        self.n_layer_att = 3
        self.unshared_obj = True
        self.unshared_reg = True
        self.fuse_method = "sum"
        self.learnable_fuse = True
        self.bf16 = True
        # serving runs the interaction and embedding stages in bf16 too
        self.serve_interact_bf16 = True
        # -----------------  testing config ------------------ #
        self.test_size = (800, 1280)
        self.test_conf = 0.01
        self.nmsthre = 0.65

    def get_model(self, generator: torch.Generator | None = None,
                  serve: bool = False, msda_method: str = "auto") -> Unicorn:
        """The Unicorn of this experiment, on the CPU, parameters drawn
        from `generator` (seed 0 when None). serve=True gives the model the
        test tools serve: with `serve_interact_bf16`, its interaction and
        embedding stages compute in bf16 (training keeps them fp32)."""
        idt = (torch.bfloat16 if serve and self.serve_interact_bf16
               else torch.float32)
        return Unicorn(
            num_classes=self.num_classes, depth=self.depth, width=self.width,
            in_channels=tuple(self.in_channels),
            backbone_name=self.backbone_name, act=self.act,
            interact_mode=self.interact_mode, embed_dim=self.embed_dim,
            use_attention=self.use_attention, n_layer_att=self.n_layer_att,
            unshared_obj=self.unshared_obj, unshared_reg=self.unshared_reg,
            fuse_method=self.fuse_method, learnable_fuse=self.learnable_fuse,
            dtype=torch.bfloat16 if self.bf16 else torch.float32,
            interact_dtype=idt, msda_method=msda_method, generator=generator)
