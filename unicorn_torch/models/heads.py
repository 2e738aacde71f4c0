"""Unified decoupled detection head and its inference decode, PyTorch (port
of unicorn_tpu/models/heads.py).

The head returns, per level, a dict of raw logits as NCHW (channels_last)
tensors: `_cls_packed` / `_reg_packed` (each tower's 1x1 predictions
computed as one matmul) and their channel slices cls, cls_sot, reg, obj,
reg_sot, obj_sot; with_mask adds `ctrl`, the CondInst controller's 169
dynamic parameters per anchor (a 3x3 conv over the reg tower, not a packed
lane). Module names follow the reference torch UnicornHead; a model with
the mask stack keeps its MaskBranch here too (`mask_branch`), where the
reference keeps it, and calls it itself: the head's forward does not.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.dynamic_conv import NUM_GEN_PARAMS
from ..utils.profiling import spanned
from .blocks import BaseConv, ConvNeXtBlock, Conv2d, DWConv

PRIOR_BIAS = -math.log((1 - 1e-2) / 1e-2)


class UnicornHead(nn.Module):
    def __init__(self, num_classes: int, width: float = 1.0,
                 strides: Sequence[int] = (8, 16, 32),
                 in_channels: Sequence[int] = (256, 512, 1024),
                 act: str = "silu", depthwise: bool = False,
                 sot_branch: bool = True, use_attention: bool = True,
                 n_layer_att: int = 3, unshared_obj: bool = True,
                 unshared_reg: bool = True, fuse_method: str = "sum",
                 learnable_fuse: bool = True, exact_gelu: bool = True,
                 num_classes_sot: int = 1, with_mask: bool = False,
                 mask_branch: nn.Module | None = None, dtype=torch.float32):
        super().__init__()
        if fuse_method not in ("sum", "mul"):
            raise ValueError(fuse_method)
        self.num_classes = num_classes
        self.fuse_method = fuse_method
        self.learnable_fuse = learnable_fuse
        self.dtype = dtype
        hidden = int(256 * width)
        conv = DWConv if depthwise else BaseConv
        kw = dict(act=act, dtype=dtype)
        n_lv = len(in_channels)

        def tower():
            return nn.Sequential(*[conv(hidden, hidden, 3, 1, **kw)
                                   for _ in range(4)])

        def preds(cout):
            return nn.ModuleList([Conv2d(hidden, cout, 1, dtype=dtype)
                                  for _ in range(n_lv)])

        self.stems = nn.ModuleList([
            BaseConv(int(c * width), hidden, 1, 1, **kw) for c in in_channels])
        self.cls_convs = nn.ModuleList([tower() for _ in range(n_lv)])
        self.reg_convs = nn.ModuleList([tower() for _ in range(n_lv)])
        self.att_layers = nn.ModuleList([
            nn.Sequential(*[ConvNeXtBlock(hidden, 1.0, dtype=dtype,
                                          exact_gelu=exact_gelu)
                            for _ in range(n_layer_att if use_attention else 0)])
            for _ in range(n_lv)])
        # (output key, module list, channels), in packed lane order
        self.cls_preds = preds(num_classes)
        self.reg_preds = preds(4)
        self.obj_preds = preds(1)
        self.cls_specs = [("cls", "cls_preds", num_classes)]
        self.reg_specs = [("reg", "reg_preds", 4), ("obj", "obj_preds", 1)]
        if sot_branch:
            self.cls_preds_sot = preds(num_classes_sot)
            self.cls_specs.append(("cls_sot", "cls_preds_sot", num_classes_sot))
            if unshared_reg:
                self.reg_preds_sot = preds(4)
                self.reg_specs.append(("reg_sot", "reg_preds_sot", 4))
            if unshared_obj:
                self.obj_preds_sot = preds(1)
                self.reg_specs.append(("obj_sot", "obj_preds_sot", 1))
        # CondInst controllers: 3x3 convs over the reg tower, 169 dynamic
        # parameters per anchor
        self.controllers = nn.ModuleList([
            Conv2d(hidden, NUM_GEN_PARAMS, 3, padding=1, dtype=dtype)
            for _ in range(n_lv)]) if with_mask else None
        self.mask_branch = mask_branch
        if fuse_method == "sum" and learnable_fuse:
            for k in range(n_lv):
                self.register_parameter(
                    f"beta_{k}", nn.Parameter(torch.ones(1, hidden, 1, 1)))

    def _init_extra(self, generator):
        with torch.no_grad():
            for _, name, _ in self.cls_specs + self.reg_specs:
                if name.startswith(("cls", "obj")):
                    for m in getattr(self, name):
                        m.bias.fill_(PRIOR_BIAS)
            for name, p in self.named_parameters(recurse=False):
                if name.startswith("beta_"):
                    p.fill_(1.0)
            # the reference trains the controllers from normal(std 0.01)
            for m in self.controllers or ():
                m.weight.normal_(0.0, 0.01, generator=generator)
                m.bias.zero_()

    def _merged(self, feat, specs, k):
        """One matmul for all of a tower's 1x1 predictions at level k."""
        dt = self.dtype
        convs = [getattr(self, name)[k] for _, name, _ in specs]
        wm = torch.cat([m.weight[:, :, 0, 0] for m in convs]).to(dt)
        bm = torch.cat([m.bias for m in convs]).to(dt)
        return F.linear(feat.permute(0, 2, 3, 1), wm, bm).permute(0, 3, 1, 2)

    def forward(self, xin, mask_in: Optional[Sequence] = None):
        """xin: NCHW FPN features at strides 8/16/32. mask_in: optional
        per-level target priors (B, 1, H, W)."""
        dt = self.dtype
        outputs = []
        for k, x in enumerate(xin):
            x = self.stems[k](x)
            if mask_in is not None:
                m = mask_in[k].to(x.dtype)
                if self.fuse_method == "sum":
                    if self.learnable_fuse:
                        x = x + m * getattr(self, f"beta_{k}").to(dt)
                    else:
                        x = x + m
                else:
                    x = x * m + x
            x = self.att_layers[k](x)
            reg_feat = self.reg_convs[k](x)
            y_cls = self._merged(self.cls_convs[k](x), self.cls_specs, k)
            y_reg = self._merged(reg_feat, self.reg_specs, k)
            out = self.unpack(y_cls, y_reg)
            if self.controllers is not None:
                out["ctrl"] = self.controllers[k](reg_feat)
            outputs.append(out)
        return outputs

    def unpack(self, y_cls, y_reg):
        """A level's packed predictions -> its output dict: the packed
        tensors and their channel slices."""
        out = {"_cls_packed": y_cls, "_reg_packed": y_reg}
        for y, specs in ((y_cls, self.cls_specs), (y_reg, self.reg_specs)):
            off = 0
            for key, _, c in specs:
                out[key] = y[:, off:off + c]
                off += c
        return out


# ---------------------------------------------------------------------------
# decoding (pure functions)
# ---------------------------------------------------------------------------

def level_grids(hw_list, strides, device=None):
    """Per-anchor x, y grid coords and strides (A,) float32 for the levels
    concatenated stride-8 first, row-major within a level."""
    xs, ys, ss = [], [], []
    for (h, w), s in zip(hw_list, strides):
        yv, xv = torch.meshgrid(torch.arange(h, device=device),
                                torch.arange(w, device=device), indexing="ij")
        xs.append(xv.reshape(-1))
        ys.append(yv.reshape(-1))
        ss.append(torch.full((h * w,), s, device=device))
    return (torch.cat(xs).float(), torch.cat(ys).float(),
            torch.cat(ss).float())


def flatten_raw_outputs(outputs, mode: str, unshared_obj=True,
                        unshared_reg=True):
    """Per-level packed head outputs -> reg_raw (B,A,4), obj_logits (B,A,1),
    cls_logits (B,A,C) in fp32, and hw (list of (H, W)); with the mask
    controllers also ctrl (B,A,169) in fp32. mode "mot" takes the shared
    branches, "sot" the SOT ones."""
    regs, objs, clss, ctrls, hw = [], [], [], [], []
    for out in outputs:
        b, _, h, w = out["_reg_packed"].shape
        hw.append((h, w))
        rp = out["_reg_packed"].permute(0, 2, 3, 1).reshape(b, h * w, -1)
        cp = out["_cls_packed"].permute(0, 2, 3, 1).reshape(b, h * w, -1)
        nc = out["cls"].shape[1]
        o_regsot = 5
        has_regsot = "reg_sot" in out
        o_objsot = o_regsot + (4 if has_regsot else 0)
        if mode == "sot":
            reg = (rp[..., o_regsot:o_regsot + 4]
                   if (unshared_reg and has_regsot) else rp[..., 0:4])
            obj = (rp[..., o_objsot:o_objsot + 1]
                   if (unshared_obj and "obj_sot" in out) else rp[..., 4:5])
            cls = cp[..., nc:nc + out["cls_sot"].shape[1]]
        else:
            reg, obj, cls = rp[..., 0:4], rp[..., 4:5], cp[..., :nc]
        regs.append(reg)
        objs.append(obj)
        clss.append(cls)
        if "ctrl" in out:
            ctrls.append(out["ctrl"].permute(0, 2, 3, 1).reshape(b, h * w, -1))
    flat = {
        "reg_raw": torch.cat(regs, 1).float(),
        "obj_logits": torch.cat(objs, 1).float(),
        "cls_logits": torch.cat(clss, 1).float(),
        "hw": hw,
    }
    if ctrls:
        flat["ctrl"] = torch.cat(ctrls, 1).float()
    return flat


def decode_boxes(reg_raw, hw_list, strides):
    """Raw reg (B, A, 4) -> cxcywh in input-image coords
    (xy = (pred + grid) * stride, wh = exp(pred) * stride)."""
    x_shifts, y_shifts, s = level_grids(hw_list, strides, reg_raw.device)
    cx = (reg_raw[..., 0] + x_shifts) * s
    cy = (reg_raw[..., 1] + y_shifts) * s
    w = torch.exp(reg_raw[..., 2]) * s
    h = torch.exp(reg_raw[..., 3]) * s
    return torch.stack([cx, cy, w, h], -1)


@spanned("postprocess.decode")
def decode_for_inference(outputs, strides, mode: str = "mot",
                         unshared_obj=True, unshared_reg=True):
    """Full inference decode -> (B, A, 5+C): [cxcywh, obj_sig, cls_sig]."""
    return decode_flat(flatten_raw_outputs(outputs, mode, unshared_obj,
                                           unshared_reg), strides)


def decode_flat(flat, strides):
    """flatten_raw_outputs' dict -> (B, A, 5+C): [cxcywh, obj_sig,
    cls_sig]."""
    boxes = decode_boxes(flat["reg_raw"], flat["hw"], strides)
    return torch.cat([boxes, torch.sigmoid(flat["obj_logits"]),
                      torch.sigmoid(flat["cls_logits"])], -1)
