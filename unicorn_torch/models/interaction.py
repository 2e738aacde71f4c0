"""Reference<->current frame feature interaction, PyTorch (port of
unicorn_tpu/models/interaction.py: the "deform", "full" and "conv" modes
and the modules around them). Module names follow the reference torch
model, so its state_dict keys line up: `bottleneck.0/.1`,
`upsample_layer.1/.3`, `pos_emb.{row,col}_embed`; "deform":
`transformer.level_embed`, `transformer.encoder.layers.N.{self_attn.*,
norm1, linear1, linear2, norm2}`; "full" (the DETR-style encoder of
transformer_encoder.py): `transformer.encoder.layers.N.{self_attn.
in_proj_weight, self_attn.in_proj_bias, self_attn.out_proj, norm1, linear1,
linear2, norm2}`; "conv" (Conv_Inter): `transformer.{conv1, norm, conv2}`.

Feature maps are NCHW (channels_last) at the modules' boundaries; inside the
two encoders tokens are (B, L*h*w, C) with the two frames ("levels")
concatenated. Parameters are fp32 and are cast to the compute dtype at use;
LayerNorm and GroupNorm run in fp32 and cast back.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.deform_attn import ms_deform_attn
from .blocks import (CL, Conv2d, GroupNorm32, LayerNorm32,
                     interpolate_bilinear, lecun_normal_, pixel_shuffle_2x)


def _xavier_uniform_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax xavier_uniform: U(-a, a), a = sqrt(6 / (fan_in + fan_out))."""
    receptive = w[0][0].numel()
    a = math.sqrt(6.0 / ((w.shape[0] + w.shape[1]) * receptive))
    with torch.no_grad():
        w.uniform_(-a, a, generator=generator)


def _linear(x, lin: nn.Linear, dtype):
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


class PositionEmbeddingLearned(nn.Module):
    """Learned row/col embedding (sz entries each) interpolated to (h, w):
    channels [col (x) | row (y)]. Output (B, 2*num_pos_feats, h, w)."""

    def __init__(self, num_pos_feats: int = 128, sz: int = 40,
                 dtype=torch.float32):
        super().__init__()
        self.sz = sz
        self.dtype = dtype
        self.row_embed = nn.Embedding(sz, num_pos_feats)
        self.col_embed = nn.Embedding(sz, num_pos_feats)

    def _init_extra(self, generator):
        with torch.no_grad():
            self.col_embed.weight.uniform_(0.0, 1.0, generator=generator)
            self.row_embed.weight.uniform_(0.0, 1.0, generator=generator)

    def forward(self, bs: int, h: int, w: int):
        sz = self.sz
        x_emb = self.col_embed.weight.t()[:, None, :].expand(-1, sz, sz)
        y_emb = self.row_embed.weight.t()[:, :, None].expand(-1, sz, sz)
        pos = torch.cat([x_emb, y_emb], 0)[None]          # (1, 2C, sz, sz)
        pos = interpolate_bilinear(pos, h, w)
        return pos.expand(bs, -1, h, w).to(self.dtype)


class Bottleneck1x1(nn.Sequential):
    """1x1 conv in `dtype` + GroupNorm(32, eps 1e-5) in fp32, projecting the
    backbone's stride-16 feature to hidden_dim."""

    def __init__(self, in_ch: int, hidden_dim: int = 256,
                 dtype=torch.float32):
        super().__init__(Conv2d(in_ch, hidden_dim, 1, dtype=dtype),
                         nn.GroupNorm(32, hidden_dim, eps=1e-5))
        self.dtype = dtype

    def _init_extra(self, generator):
        _xavier_uniform_(self[0].weight, generator)

    def forward(self, x):
        y = self[1](self[0](x).float())
        return y.to(self.dtype, memory_format=CL)


class UpsampleEmbed(nn.Sequential):
    """PixelShuffle(2) + 3x3 conv + ReLU + 3x3 conv: the stride-16 feature
    to the stride-8 embedding map."""

    def __init__(self, embed_dim: int = 128, hidden_dim: int = 256,
                 dtype=torch.float32):
        super().__init__(
            nn.PixelShuffle(2),
            Conv2d(hidden_dim // 4, hidden_dim, 3, padding=1, dtype=dtype),
            nn.ReLU(),
            Conv2d(hidden_dim, embed_dim, 3, padding=1, dtype=dtype))

    def forward(self, x):
        x = pixel_shuffle_2x(x).contiguous(memory_format=CL)
        return self[3](F.relu(self[1](x)))


class ConvInteraction(nn.Module):
    """Per-frame conv interaction: 3x3 conv (no bias) -> GroupNorm -> ReLU
    -> 1x1 conv, the same weights for both frames; no position input."""

    def __init__(self, d_model: int = 256, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(d_model, d_model, 3, padding=1, bias=False,
                            dtype=dtype)
        self.norm = GroupNorm32(d_model, dtype=dtype)
        self.conv2 = Conv2d(d_model, d_model, 1, dtype=dtype)

    def forward(self, feats):
        return tuple(self.conv2(F.relu(self.norm(self.conv1(x))))
                     for x in feats)


class MultiheadAttention(nn.Module):
    """The parameters of nn.MultiheadAttention (in_proj_weight = [q; k; v]
    rows, out_proj), applied by FullAttentionLayer."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)

    def _init_extra(self, generator):
        # flax lecun_normal on each of the query, key and value kernels:
        # fan_in d_model, as for the joined (3 d_model, d_model) rows
        lecun_normal_(self.in_proj_weight, generator)
        with torch.no_grad():
            self.in_proj_bias.zero_()


class FullAttentionLayer(nn.Module):
    """Post-norm transformer encoder layer: self-attention with the position
    added to queries and keys, then the ReLU FFN. The projections, scores
    and softmax give `dtype` outputs, as flax's do (in bf16 flax rounds each
    step of its softmax, F.scaled_dot_product_attention only its output);
    the norms run in fp32."""

    def __init__(self, d_model: int = 256, nhead: int = 8,
                 dim_feedforward: int = 2048, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.norm1 = LayerNorm32(d_model, 1e-6, dtype=dtype)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm2 = LayerNorm32(d_model, 1e-6, dtype=dtype)

    def attention(self, src, pos):
        """src, pos (B, L, C) -> the attention's output projection (B, L,
        C), in `dtype`."""
        dt = self.dtype
        att = self.self_attn
        B, L, C = src.shape
        M = att.nhead
        w, b = att.in_proj_weight.to(dt), att.in_proj_bias.to(dt)
        qk = src + pos

        def heads(x, i):
            y = F.linear(x, w[i * C:(i + 1) * C], b[i * C:(i + 1) * C])
            return y.reshape(B, L, M, C // M).transpose(1, 2)

        # flax scales the query before the product, in the compute dtype
        q = heads(qk, 0) / math.sqrt(C // M)
        out = F.scaled_dot_product_attention(q, heads(qk, 1), heads(src, 2),
                                             scale=1.0)
        out = out.transpose(1, 2).reshape(B, L, C)
        return _linear(out, att.out_proj, dt)

    def forward(self, src, pos):
        dt = self.dtype
        src = src.to(dt)
        src = self.norm1(src + self.attention(src, pos.to(dt)))
        ff = _linear(F.relu(_linear(src, self.linear1, dt)), self.linear2, dt)
        return self.norm2(src + ff)


class FullAttentionInteraction(nn.Module):
    """Joint full attention over both frames' tokens (num_layers encoder
    layers). feats, pos: two (B, C, h, w) maps each. Returns the refined
    pair."""

    def __init__(self, d_model: int = 256, nhead: int = 8,
                 num_layers: int = 1, dtype=torch.float32):
        super().__init__()
        self.encoder = _Encoder([FullAttentionLayer(d_model, nhead,
                                                    dtype=dtype)
                                 for _ in range(num_layers)])

    def forward(self, feats, pos):
        b, c, h, w = feats[0].shape
        src = torch.cat([_tokens(f) for f in feats], 1)
        p = torch.cat([_tokens(x) for x in pos], 1)
        for layer in self.encoder.layers:
            src = layer(src, p)
        return _untokens(src, b, c, h, w)


def _tokens(x):
    """(B, C, h, w) -> (B, h*w, C)."""
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


def _untokens(src, b, c, h, w):
    """(B, 2*h*w, C) tokens of two frames -> the two (B, C, h, w) maps."""
    return tuple(f.reshape(b, h, w, c).permute(0, 3, 1, 2)
                 for f in (src[:, :h * w], src[:, h * w:]))


def offset_bias_init(n_heads: int, n_levels: int, n_points: int):
    """Directional point-offset bias of MSDeformAttn: head m looks along
    angle 2*pi*m/M, point p at distance p+1. Returns (M*L*P*2,)."""
    thetas = torch.arange(n_heads, dtype=torch.float32) * (
        2.0 * math.pi / n_heads)
    grid = torch.stack([torch.cos(thetas), torch.sin(thetas)], -1)  # (M, 2)
    grid = grid / grid.abs().amax(-1, keepdim=True)
    grid = grid[:, None, None, :].repeat(1, n_levels, n_points, 1)
    scale = torch.arange(1, n_points + 1, dtype=torch.float32)
    return (grid * scale[None, None, :, None]).reshape(-1)


class MSDeformAttn(nn.Module):
    """The four projections of deformable attention (the reference's
    MSDeformAttn parameters); the layer below applies them."""

    def __init__(self, d_model: int, n_heads: int, n_levels: int,
                 n_points: int):
        super().__init__()
        self.shape = (n_heads, n_levels, n_points)
        n = n_heads * n_levels * n_points
        self.sampling_offsets = nn.Linear(d_model, n * 2)
        self.attention_weights = nn.Linear(d_model, n)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)

    def _init_extra(self, generator):
        with torch.no_grad():
            self.sampling_offsets.weight.zero_()
            self.sampling_offsets.bias.copy_(offset_bias_init(*self.shape))
            self.attention_weights.weight.zero_()
        _xavier_uniform_(self.value_proj.weight, generator)
        _xavier_uniform_(self.output_proj.weight, generator)


class MSDeformAttnLayer(nn.Module):
    """Deformable self-attention encoder layer over two equal-shape frame
    'levels': sampling + output projection, post-norm, then the FFN."""

    def __init__(self, d_model: int = 256, n_heads: int = 8,
                 n_points: int = 4, n_levels: int = 2,
                 dim_feedforward: int = 1024, dtype=torch.float32,
                 msda_method: str = "auto"):
        super().__init__()
        self.n_heads, self.n_points, self.n_levels = n_heads, n_points, n_levels
        self.dtype = dtype
        self.msda_method = msda_method
        self.self_attn = MSDeformAttn(d_model, n_heads, n_levels, n_points)
        self.norm1 = LayerNorm32(d_model, 1e-6, dtype=dtype)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm2 = LayerNorm32(d_model, 1e-6, dtype=dtype)

    def sampling(self, src, pos, h: int, w: int):
        """(value (B,L,h,w,M,D), locations (B,Lq,M,L,P,2) fp32, weights
        (B,Lq,M,L,P)) of this layer for tokens src, pos (B, L*h*w, C)."""
        dt = self.dtype
        B, Lq, C = src.shape
        M, L, P = self.n_heads, self.n_levels, self.n_points
        att = self.self_attn
        query = src + pos
        offsets = _linear(query, att.sampling_offsets, dt).reshape(
            B, Lq, M, L, P, 2)
        attw = _linear(query, att.attention_weights, dt).reshape(
            B, Lq, M, L * P)
        attw = torch.softmax(attw, -1).reshape(B, Lq, M, L, P)
        value = _linear(src, att.value_proj, dt).reshape(B, L, h, w, M, C // M)
        # reference points: the query's own normalised cell centre, the same
        # for both levels; fp32, so the locations are fp32 whatever dt is
        dev = src.device
        ys = (torch.arange(h, device=dev, dtype=torch.float32) + 0.5) / h
        xs = (torch.arange(w, device=dev, dtype=torch.float32) + 0.5) / w
        ref = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)],
                          -1).reshape(h * w, 2).repeat(L, 1)       # (Lq, 2)
        norm = torch.tensor([w, h], dtype=torch.float32, device=dev)
        locs = ref[None, :, None, None, None, :] + offsets / norm
        return value, locs, attw

    def forward(self, src, pos, h: int, w: int):
        """src, pos: (B, L*h*w, C), the levels concatenated."""
        dt = self.dtype
        src = src.to(dt)
        value, locs, attw = self.sampling(src, pos.to(dt), h, w)
        out = ms_deform_attn(value.contiguous(), locs.contiguous(),
                             attw.contiguous(), method=self.msda_method)
        src = self.norm1(src + _linear(out, self.self_attn.output_proj, dt))
        ff = _linear(F.relu(_linear(src, self.linear1, dt)), self.linear2, dt)
        return self.norm2(src + ff)


class _Encoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class DeformableInteraction(nn.Module):
    """1-layer deformable encoder over the two frames. feats: two (B, C, h,
    w) maps; pos: their position embeddings. Returns the refined pair."""

    def __init__(self, d_model: int = 256, n_heads: int = 8,
                 n_points: int = 4, num_layers: int = 1, dtype=torch.float32,
                 msda_method: str = "auto"):
        super().__init__()
        self.dtype = dtype
        self.level_embed = nn.Parameter(torch.empty(2, d_model))
        self.encoder = _Encoder([
            MSDeformAttnLayer(d_model, n_heads, n_points, 2, dtype=dtype,
                              msda_method=msda_method)
            for _ in range(num_layers)])

    def _init_extra(self, generator):
        with torch.no_grad():
            self.level_embed.normal_(0.0, 1.0, generator=generator)

    def forward(self, feats, pos):
        b, c, h, w = feats[0].shape
        src = torch.cat([_tokens(f) for f in feats], 1)
        p = torch.cat([_tokens(x) + self.level_embed[i].to(self.dtype)
                       for i, x in enumerate(pos)], 1)
        for layer in self.encoder.layers:
            src = layer(src, p, h, w)
        return _untokens(src, b, c, h, w)
