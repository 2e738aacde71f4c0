"""The plain reference of the Unicorn model: ConvNeXt trunk, YOLO PAFPN,
the unified head, the deformable interaction and the embedding upsample.

A frozen copy of the port's models (`unicorn_torch/models/`: blocks.py,
convnext.py, pafpn.py, heads.py, interaction.py, unicorn.py) at the time
the benchmark was written, with every kernel in its plain form: the
depthwise 7x7 convolution is `F.conv2d(groups=C)`, multi-scale deformable
attention a gather (`plain.ms_deform_attn`). Everything computes in fp32;
each product's operands pass through the module's quantiser `q`
(precision.py), exact for the reference, lower for the control. Parameter
names are the port's, so one state dict loads into both. Imports nothing
of the program.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import plain
from .precision import exact



class _Q:
    """Mixin: the quantiser of this module's products."""
    q = staticmethod(exact)


def set_quantisers(model: nn.Module, main, inter) -> None:
    """`main` for the trunk, neck and head (bf16 in the configurations),
    `inter` for the interaction and the embedding stages (fp32)."""
    for name, m in model.named_modules():
        if isinstance(m, _Q):
            top = name.split(".")[0]
            m.q = main if top in ("backbone", "head") else inter


class Conv2d(nn.Conv2d, _Q):
    def __init__(self, in_ch, out_ch, ksize, stride=1, padding=0, groups=1,
                 bias=True, same=False):
        super().__init__(in_ch, out_ch, ksize, stride, padding, groups=groups,
                         bias=bias)
        self.same = same

    def forward(self, x):
        if self.same:
            pads = []
            for n, k, s in zip(x.shape[2:][::-1], self.kernel_size[::-1],
                               self.stride[::-1]):
                total = max((-(-n // s) - 1) * s + k - n, 0)
                pads += [total // 2, total - total // 2]
            if any(pads):
                x = F.pad(x, pads)
        q = self.q
        b = None if self.bias is None else q(self.bias)
        return F.conv2d(q(x.float()), q(self.weight), b, self.stride,
                        self.padding, groups=self.groups)


def linear(x, lin: nn.Linear, q):
    return F.linear(q(x.float()), q(lin.weight), q(lin.bias))


class GroupNorm32(nn.Module):
    def __init__(self, channels: int, num_groups: int = 16):
        super().__init__()
        self.groups = min(num_groups, channels)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return F.group_norm(x.float(), self.groups, self.weight, self.bias,
                            1e-3)


class LayerNorm32(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-6,
                 channels_first: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps
        self.channels_first = channels_first

    def forward(self, x):
        if self.channels_first:
            return self._ln(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return self._ln(x)

    def _ln(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias,
                            self.eps)


class BaseConv(nn.Module):
    def __init__(self, in_ch, out_ch, ksize=1, stride=1, groups=1):
        super().__init__()
        pad = (ksize - 1) // 2
        self.conv = Conv2d(in_ch, out_ch, ksize, stride, pad, groups=groups,
                           bias=False)
        self.bn = GroupNorm32(out_ch)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.conv1 = BaseConv(in_ch, out_ch, 1, 1)
        self.conv2 = BaseConv(out_ch, out_ch, 3, 1)

    def forward(self, x):
        return self.conv2(self.conv1(x))   # shortcut=False in the PAFPN


class CSPLayer(nn.Module):
    def __init__(self, in_ch, out_ch, n=1):
        super().__init__()
        hidden = int(out_ch * 0.5)
        self.conv1 = BaseConv(in_ch, hidden, 1, 1)
        self.conv2 = BaseConv(in_ch, hidden, 1, 1)
        self.conv3 = BaseConv(2 * hidden, out_ch, 1, 1)
        self.m = nn.Sequential(*[Bottleneck(hidden, hidden) for _ in range(n)])

    def forward(self, x):
        return self.conv3(torch.cat([self.m(self.conv1(x)), self.conv2(x)], 1))


class DepthwiseConv7x7(nn.Module, _Q):
    """The dw7x7 kernel's plain form: a SAME depthwise convolution."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.weight = nn.Parameter(torch.empty(dim, 1, 7, 7))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        q = self.q
        return F.conv2d(q(x.float()), q(self.weight), q(self.bias), padding=3,
                        groups=self.dim)


class ConvNeXtBlock(nn.Module, _Q):
    remat = False

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = DepthwiseConv7x7(dim)
        self.norm = LayerNorm32(dim, 1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.ones(dim))

    def _block(self, x):
        y = self.dwconv(x).permute(0, 2, 3, 1)
        y = self.norm(y)
        y = F.gelu(linear(y, self.pwconv1, self.q))
        y = linear(y, self.pwconv2, self.q) * self.q(self.gamma)
        return x.float() + y.permute(0, 3, 1, 2)

    def forward(self, x):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(self._block, x, use_reentrant=False)
        return self._block(x)


class PatchEmbed4x4(nn.Module, _Q):
    def __init__(self, features: int, in_chans: int = 3):
        super().__init__()
        self.in_chans = in_chans
        self.weight = nn.Parameter(torch.empty(features, in_chans, 4, 4))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        b, c, h, w = x.shape
        xn = x.permute(0, 2, 3, 1).reshape(b, h // 4, 4, w // 4, 4, c)
        xn = xn.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 4, w // 4, 16 * c)
        wm = self.weight.permute(2, 3, 1, 0).reshape(16 * c, -1)
        y = self.q(xn.float()) @ self.q(wm) + self.q(self.bias)
        return y.permute(0, 3, 1, 2)


class ConvNeXt(nn.Module):
    def __init__(self, depths, dims, remat=False):
        super().__init__()
        self.downsample_layers = nn.ModuleList([nn.Sequential(
            PatchEmbed4x4(dims[0]), LayerNorm32(dims[0], channels_first=True))])
        for i in range(1, 4):
            self.downsample_layers.append(nn.Sequential(
                LayerNorm32(dims[i - 1], channels_first=True),
                Conv2d(dims[i - 1], dims[i], 2, 2, same=True)))
        self.stages = nn.ModuleList([
            nn.Sequential(*[ConvNeXtBlock(dims[i]) for _ in range(depths[i])])
            for i in range(4)])
        for i in range(1, 4):
            self.add_module(f"norm{i}", LayerNorm32(dims[i],
                                                    channels_first=True))
        for stage in self.stages:
            for block in stage:
                block.remat = bool(remat)

    def forward(self, x):
        outs = []
        for i in range(4):
            x = self.stages[i](self.downsample_layers[i](x))
            if i >= 1:
                outs.append(getattr(self, f"norm{i}")(x))
        return tuple(outs)


CONVNEXT = {   # name: (depths, dims)
    "convnext_tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "convnext_base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "convnext_large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
}


def upsample_nearest_2x(x):
    return x.repeat_interleave(2, 2).repeat_interleave(2, 3)


class YOLOPAFPN(nn.Module):
    def __init__(self, depth, width, in_channels, backbone_name, remat=False):
        super().__init__()
        depths, dims = CONVNEXT[backbone_name]
        self.backbone = ConvNeXt(depths, dims, remat)
        raw = tuple(dims[1:])
        c0, c1, c2 = [int(c * width) for c in in_channels]
        self.adjust = raw != (c0, c1, c2)
        if self.adjust:
            self.adjust2 = BaseConv(raw[0], c0, 1, 1)
            self.adjust1 = BaseConv(raw[1], c1, 1, 1)
            self.adjust0 = BaseConv(raw[2], c2, 1, 1)
        n = round(3 * depth)
        self.lateral_conv0 = BaseConv(c2, c1, 1, 1)
        self.C3_p4 = CSPLayer(2 * c1, c1, n)
        self.reduce_conv1 = BaseConv(c1, c0, 1, 1)
        self.C3_p3 = CSPLayer(2 * c0, c0, n)
        self.bu_conv2 = BaseConv(c0, c0, 3, 2)
        self.C3_n3 = CSPLayer(2 * c0, c1, n)
        self.bu_conv1 = BaseConv(c1, c1, 3, 2)
        self.C3_n4 = CSPLayer(2 * c1, c2, n)

    def forward(self, x):
        """-> ((pan_out2, pan_out1, pan_out0), raw stride-16 feature)."""
        x2, x1, x0 = self.backbone(x)
        a2, a1, a0 = ((self.adjust2(x2), self.adjust1(x1), self.adjust0(x0))
                      if self.adjust else (x2, x1, x0))
        fpn_out0 = self.lateral_conv0(a0)
        f_out0 = self.C3_p4(torch.cat([upsample_nearest_2x(fpn_out0), a1], 1))
        fpn_out1 = self.reduce_conv1(f_out0)
        pan_out2 = self.C3_p3(torch.cat([upsample_nearest_2x(fpn_out1), a2], 1))
        pan_out1 = self.C3_n3(torch.cat([self.bu_conv2(pan_out2), fpn_out1], 1))
        pan_out0 = self.C3_n4(torch.cat([self.bu_conv1(pan_out1), fpn_out0], 1))
        return (pan_out2, pan_out1, pan_out0), x1


class UnicornHead(nn.Module, _Q):
    """The unified head with the SOT branch (unshared obj and reg), the
    attention blocks and the learnable prior fusion ("sum")."""

    def __init__(self, num_classes, width, in_channels, n_layer_att):
        super().__init__()
        hidden = int(256 * width)
        n_lv = len(in_channels)

        def tower():
            return nn.Sequential(*[BaseConv(hidden, hidden, 3, 1)
                                   for _ in range(4)])

        def preds(cout):
            return nn.ModuleList([Conv2d(hidden, cout, 1) for _ in range(n_lv)])

        self.stems = nn.ModuleList([BaseConv(int(c * width), hidden, 1, 1)
                                    for c in in_channels])
        self.cls_convs = nn.ModuleList([tower() for _ in range(n_lv)])
        self.reg_convs = nn.ModuleList([tower() for _ in range(n_lv)])
        self.att_layers = nn.ModuleList([
            nn.Sequential(*[ConvNeXtBlock(hidden) for _ in range(n_layer_att)])
            for _ in range(n_lv)])
        self.cls_preds = preds(num_classes)
        self.reg_preds = preds(4)
        self.obj_preds = preds(1)
        self.cls_preds_sot = preds(1)
        self.reg_preds_sot = preds(4)
        self.obj_preds_sot = preds(1)
        for k in range(n_lv):
            self.register_parameter(f"beta_{k}",
                                    nn.Parameter(torch.ones(1, hidden, 1, 1)))

    def forward(self, xin, priors):
        """-> per level {"cls", "cls_sot", "reg", "obj", "reg_sot",
        "obj_sot"} raw logits, NCHW fp32."""
        outputs = []
        for k, x in enumerate(xin):
            x = self.stems[k](x)
            x = x + priors[k].float() * self.q(getattr(self, f"beta_{k}"))
            x = self.att_layers[k](x)
            reg_feat = self.reg_convs[k](x)
            cls_feat = self.cls_convs[k](x)
            outputs.append({
                "cls": self.cls_preds[k](cls_feat),
                "cls_sot": self.cls_preds_sot[k](cls_feat),
                "reg": self.reg_preds[k](reg_feat),
                "obj": self.obj_preds[k](reg_feat),
                "reg_sot": self.reg_preds_sot[k](reg_feat),
                "obj_sot": self.obj_preds_sot[k](reg_feat)})
        return outputs


class PositionEmbeddingLearned(nn.Module):
    def __init__(self, num_pos_feats: int = 128, sz: int = 40):
        super().__init__()
        self.sz = sz
        self.row_embed = nn.Embedding(sz, num_pos_feats)
        self.col_embed = nn.Embedding(sz, num_pos_feats)

    def forward(self, bs: int, h: int, w: int):
        sz = self.sz
        x_emb = self.col_embed.weight.t()[:, None, :].expand(-1, sz, sz)
        y_emb = self.row_embed.weight.t()[:, :, None].expand(-1, sz, sz)
        pos = torch.cat([x_emb, y_emb], 0)[None]
        pos = F.interpolate(pos, size=(h, w), mode="bilinear",
                            align_corners=False, antialias=False)
        return pos.expand(bs, -1, h, w)


class Bottleneck1x1(nn.Sequential):
    def __init__(self, in_ch: int, hidden_dim: int = 256):
        super().__init__(Conv2d(in_ch, hidden_dim, 1),
                         nn.GroupNorm(32, hidden_dim, eps=1e-5))

    def forward(self, x):
        return self[1](self[0](x))


class UpsampleEmbed(nn.Sequential):
    def __init__(self, embed_dim: int = 128, hidden_dim: int = 256):
        super().__init__(nn.PixelShuffle(2),
                         Conv2d(hidden_dim // 4, hidden_dim, 3, padding=1),
                         nn.ReLU(),
                         Conv2d(hidden_dim, embed_dim, 3, padding=1))

    def forward(self, x):
        return self[3](F.relu(self[1](F.pixel_shuffle(x, 2))))


class MSDeformAttn(nn.Module):
    def __init__(self, d_model, n_heads, n_levels, n_points):
        super().__init__()
        n = n_heads * n_levels * n_points
        self.sampling_offsets = nn.Linear(d_model, n * 2)
        self.attention_weights = nn.Linear(d_model, n)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)


class MSDeformAttnLayer(nn.Module, _Q):
    def __init__(self, d_model=256, n_heads=8, n_points=4, n_levels=2,
                 dim_feedforward=1024):
        super().__init__()
        self.n_heads, self.n_points, self.n_levels = n_heads, n_points, n_levels
        self.self_attn = MSDeformAttn(d_model, n_heads, n_levels, n_points)
        self.norm1 = LayerNorm32(d_model, 1e-6)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm2 = LayerNorm32(d_model, 1e-6)

    def forward(self, src, pos, h: int, w: int):
        q = self.q
        B, Lq, C = src.shape
        M, L, P = self.n_heads, self.n_levels, self.n_points
        att = self.self_attn
        query = src + pos
        offsets = linear(query, att.sampling_offsets, q).reshape(
            B, Lq, M, L, P, 2)
        attw = linear(query, att.attention_weights, q).reshape(B, Lq, M, L * P)
        attw = torch.softmax(attw, -1).reshape(B, Lq, M, L, P)
        value = linear(src, att.value_proj, q).reshape(B, L, h, w, M, C // M)
        dev = src.device
        ys = (torch.arange(h, device=dev, dtype=torch.float32) + 0.5) / h
        xs = (torch.arange(w, device=dev, dtype=torch.float32) + 0.5) / w
        ref = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)],
                          -1).reshape(h * w, 2).repeat(L, 1)
        norm = torch.tensor([w, h], dtype=torch.float32, device=dev)
        locs = ref[None, :, None, None, None, :] + offsets / norm
        out = plain.ms_deform_attn(q(value), locs, q(attw))
        src = self.norm1(src + linear(out, att.output_proj, q))
        ff = linear(F.relu(linear(src, self.linear1, q)), self.linear2, q)
        return self.norm2(src + ff)


class _Encoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


def _tokens(x):
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


class DeformableInteraction(nn.Module):
    def __init__(self, d_model: int = 256):
        super().__init__()
        self.level_embed = nn.Parameter(torch.empty(2, d_model))
        self.encoder = _Encoder([MSDeformAttnLayer(d_model)])

    def forward(self, feats, pos):
        b, c, h, w = feats[0].shape
        src = torch.cat([_tokens(f) for f in feats], 1)
        p = torch.cat([_tokens(x) + self.level_embed[i]
                       for i, x in enumerate(pos)], 1)
        for layer in self.encoder.layers:
            src = layer(src, p, h, w)
        return tuple(f.reshape(b, h, w, c).permute(0, 3, 1, 2)
                     for f in (src[:, :h * w], src[:, h * w:]))


class Unicorn(nn.Module):
    """The "deform" Unicorn of the track exps, fp32 parameters."""

    def __init__(self, num_classes=8, depth=1.0, width=1.0,
                 in_channels=(192, 384, 768), backbone_name="convnext_tiny",
                 embed_dim=128, hidden_dim=256, n_layer_att=3, remat=False):
        super().__init__()
        self.backbone = YOLOPAFPN(depth, width, in_channels, backbone_name,
                                  remat)
        self.head = UnicornHead(num_classes, width, in_channels, n_layer_att)
        raw16 = CONVNEXT[backbone_name][1][2]
        self.bottleneck = Bottleneck1x1(raw16, hidden_dim)
        self.upsample_layer = UpsampleEmbed(embed_dim, hidden_dim)
        self.pos_emb = PositionEmbeddingLearned(hidden_dim // 2, sz=40)
        self.transformer = DeformableInteraction(hidden_dim)

    def forward_backbone(self, imgs):
        return self.backbone(imgs)

    def forward_interaction(self, feat0, feat1):
        b, _, h, w = feat0.shape
        srcs = (self.bottleneck(feat0), self.bottleneck(feat1))
        pos = self.pos_emb(b, h, w)
        return self.transformer(srcs, (pos, pos))

    def forward_upsample(self, feat):
        return self.upsample_layer(feat)

    def forward_head(self, fpn_outs, priors):
        return self.head(fpn_outs, priors)

    def forward_whole(self, imgs):
        """The MOT detection forward: trunk, neck, head with zero priors."""
        fpn_outs, _ = self.forward_backbone(imgs)
        priors = tuple(f.new_zeros((f.shape[0], 1) + tuple(f.shape[2:]))
                       for f in fpn_outs)
        return self.head(fpn_outs, priors)


def model_args(exp: dict, remat=None) -> dict:
    """Unicorn's arguments from a configuration file's `exp_fields`."""
    return dict(num_classes=exp["num_classes"], depth=exp["depth"],
                width=exp["width"], in_channels=tuple(exp["in_channels"]),
                backbone_name=exp["backbone_name"],
                embed_dim=exp["embed_dim"], n_layer_att=exp["n_layer_att"],
                remat=exp["remat"] if remat is None else remat)


def build(exp: dict, device, remat=None) -> Unicorn:
    """The reference model of a configuration's `exp_fields` on `device`,
    parameters not yet set (load weights into it)."""
    with torch.device(device):
        return Unicorn(**model_args(exp, remat))
