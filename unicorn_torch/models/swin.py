"""Swin Transformer backbone, PyTorch (port of unicorn_tpu/models/swin.py).

Windowed attention with shifted windows on (B, H, W, C) tokens: the NHWC
view of the port's channels_last NCHW maps, so no copy is made at either
end. Outputs the stride-8/16/32 features of stages 1..3, each through its
output LayerNorm, which comes before the stage's patch merging. Module
names are the public Swin release's (patch_embed.{proj,norm},
layers.{i}.blocks.{j}.{norm1,attn.qkv,attn.proj,
attn.relative_position_bias_table,norm2,mlp.fc1,mlp.fc2},
layers.{i}.downsample.{norm,reduction}, norm{i}).

As in the JAX model, and unlike the public release:
  * LayerNorms use flax's eps 1e-6, computed in fp32, then cast;
  * patch merging concatenates the 2x2 neighbours in (row, col) order
    (0,0), (0,1), (1,0), (1,1) (the public release: (0,0), (1,0), (0,1),
    (1,1));
  * the window clamps to min(window, H, W); the shift is 0 when the window
    covers the shorter side, else min(shift, window - 1); the map is padded
    with zeros after norm1, bottom and right, to window multiples, and the
    padded tokens are masked only by the shift mask;
  * the relative-position table keeps its (2 * 7 - 1)^2 rows whatever the
    effective window, and a clamped window indexes inside it;
  * q is scaled after the qkv projection in the compute dtype; logits, bias
    and mask add in the compute dtype and the softmax runs in fp32;
  * the MLP's GELU is always exact (erf);
  * any truthy `remat` recomputes whole blocks in the backward.

Inside `parallel.rows.row_sharded` a block holds only its rank's rows of
the frame and computes on them what the whole-map block computes there
(`SwinBlock._forward_rows`); the patch embedding (4x4 / 4, no halo), the
patch merging (every rank holds an even number of rows down to stride 16)
and the LayerNorms need no exchange.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel import rows
from .blocks import CL, Conv2d, LayerNorm32


def window_partition(x, ws: int):
    """(B, H, W, C) -> (B * nW, ws * ws, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def window_reverse(windows, ws: int, H: int, W: int):
    """(B * nW, ws * ws, C) -> (B, H, W, C)."""
    B = windows.shape[0] // ((H // ws) * (W // ws))
    x = windows.reshape(B, H // ws, W // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


def relative_position_index(ws: int, table_ws: int | None = None):
    """(ws^2, ws^2) int64 index into the (2 * table_ws - 1)^2 bias table for
    an effective window ws <= table_ws."""
    table_ws = table_ws or ws
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + table_ws - 1
    return torch.from_numpy(rel[..., 0] * (2 * table_ws - 1) + rel[..., 1])


def shift_mask(Hp: int, Wp: int, ws: int, ss: int):
    """(nW, ws^2, ws^2) float32: -100 between tokens of a shifted window
    that come from different regions of the padded Hp x Wp map, else 0."""
    img = torch.zeros(1, Hp, Wp, 1)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)):
        for wsl in (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    mw = window_partition(img, ws).reshape(-1, ws * ws)
    return torch.where(mw[:, None, :] != mw[:, :, None], -100.0, 0.0)


class WindowAttention(nn.Module):
    """Multi-head self-attention within windows, with a learned relative
    position bias. The table (relative_position_bias_table, ((2 *
    table_window - 1)^2, heads), 2-D so that weight decay takes it, as JAX's
    ndim > 1 rule does) is indexed for the window each call gives."""

    def __init__(self, dim: int, num_heads: int, table_window: int = 7,
                 dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.table_window = table_window
        self.dtype = dtype
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * table_window - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             relative_position_index(table_window),
                             persistent=False)

    def _init_extra(self, generator):
        with torch.no_grad():
            self.relative_position_bias_table.normal_(0.0, 0.02,
                                                      generator=generator)

    def bias(self, ws: int):
        """(heads, ws^2, ws^2) fp32 relative position bias of a ws window."""
        idx = self.relative_position_index
        if ws != self.table_window:     # a clamped window, on small maps
            idx = relative_position_index(ws, self.table_window).to(
                idx.device)
        n = ws * ws
        return self.relative_position_bias_table[idx.reshape(-1)].reshape(
            n, n, -1).permute(2, 0, 1)

    def forward(self, x, ws: int, mask=None):
        """x (B * nW, ws^2, C) in the compute dtype; mask (nW, ws^2, ws^2)
        fp32 or None."""
        dt = self.dtype
        Bn, N, C = x.shape
        h = self.num_heads
        qkv = F.linear(x, self.qkv.weight.to(dt), self.qkv.bias.to(dt))
        qkv = qkv.reshape(Bn, N, 3, h, C // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * (C // h) ** -0.5, qkv[1], qkv[2]
        attn = q @ k.transpose(-2, -1)
        attn = attn + self.bias(ws).to(dt)[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(Bn // nW, nW, h, N, N)
                    + mask[None, :, None].to(dt)).reshape(Bn, h, N, N)
        attn = torch.softmax(attn.float(), -1).to(dt)
        out = (attn @ v).transpose(1, 2).reshape(Bn, N, C)
        return F.linear(out, self.proj.weight.to(dt), self.proj.bias.to(dt))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        dt = self.dtype
        x = F.gelu(F.linear(x, self.fc1.weight.to(dt), self.fc1.bias.to(dt)))
        return F.linear(x, self.fc2.weight.to(dt), self.fc2.bias.to(dt))


class SwinBlock(nn.Module):
    """norm1 -> (shifted) window attention -> + residual -> norm2 -> MLP ->
    + residual, on (B, H, W, C). The shift masks are cached per (Hp, Wp,
    ws, ss, device)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift_size: int = 0, mlp_ratio: float = 4.0,
                 dtype=torch.float32):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = LayerNorm32(dim, 1e-6, dtype=dtype)
        self.attn = WindowAttention(dim, num_heads, window_size, dtype=dtype)
        self.norm2 = LayerNorm32(dim, 1e-6, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)
        self._masks = {}

    def _mask(self, Hp, Wp, ws, ss, device, bands=None):
        """The shift mask of the padded Hp x Wp map; with `bands`, only the
        windows of those bands of ws rows, in that order."""
        key = (Hp, Wp, ws, ss, device, bands)
        if key not in self._masks:
            mask = shift_mask(Hp, Wp, ws, ss)
            if bands is not None:
                n = ws * ws
                mask = mask.reshape(Hp // ws, -1, n, n)[list(bands)].reshape(
                    -1, n, n)
            self._masks[key] = mask.to(device)
        return self._masks[key]

    def _geometry(self, H, W):
        """(window, shift, bottom pad, right pad) of an H x W map."""
        ws = min(self.window_size, H, W)
        ss = 0 if ws == min(H, W) else min(self.shift_size, ws - 1)
        return ws, ss, (-H) % ws, (-W) % ws

    def forward(self, x):
        plan = rows.active()
        if plan:
            return self._forward_rows(x, plan)
        B, H, W, C = x.shape
        ws, ss, pad_b, pad_r = self._geometry(H, W)
        shortcut = x
        x = self.norm1(x)
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        mask = None
        if ss > 0:
            x = torch.roll(x, (-ss, -ss), (1, 2))
            mask = self._mask(Hp, Wp, ws, ss, x.device)
        x = window_reverse(self.attn(window_partition(x, ws), ws, mask),
                           ws, Hp, Wp)
        if ss > 0:
            x = torch.roll(x, (ss, ss), (1, 2))
        x = shortcut + x[:, :H, :W]
        return x + self.mlp(self.norm2(x))

    def _forward_rows(self, x, plan):
        """x (B, rows, W, C), this rank's block of the frame's rows under
        `plan`. The window, shift and pads follow the frame's height H. In
        the padded Hp-row frame, rolled up by the shift, the windows lie in
        bands of ws rows: band k holds frame rows k * ws + ss ... k * ws +
        ss + ws - 1, modulo Hp (the last band of a shifted block wraps: the
        frame's last rows and pad rows with its first ss rows). The rank
        takes every row of each band that meets its rows, as the other
        ranks' norm1 outputs give them (zeros below H), runs the windows of
        those bands with the whole frame's mask, and keeps its own rows. A
        band shared by two ranks is computed on both."""
        B, h, W, C = x.shape
        bounds = plan.bounds(h)
        start, stop = bounds[plan.rank]
        H = bounds[-1][1]
        ws, ss, pad_b, pad_r = self._geometry(H, W)
        Hp, Wp = H + pad_b, W + pad_r
        bands = tuple(sorted({(g - ss) % Hp // ws
                              for g in range(start, stop)}))
        index = [(k * ws + ss + j) % Hp for k in bands for j in range(ws)]
        at = {g: i for i, g in enumerate(index)}
        own = torch.tensor([at[g] for g in range(start, stop)],
                           device=x.device)
        shortcut = x
        xn = self.norm1(x).permute(0, 3, 1, 2)            # NCHW view
        strips = rows.exchange(rows.edge_strips(xn, max(ws - 1, 1)), plan)
        x = rows.take_rows(xn, strips, plan, index).transpose(0, 1)
        x = F.pad(x, (0, 0, 0, pad_r))
        mask = None
        if ss > 0:
            x = torch.roll(x, -ss, 2)
            mask = self._mask(Hp, Wp, ws, ss, x.device, bands)
        x = window_reverse(self.attn(window_partition(x, ws), ws, mask),
                           ws, len(index), Wp)
        if ss > 0:
            x = torch.roll(x, ss, 2)
        x = shortcut + x[:, own, :W]
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """2x2 neighbours -> 4C channels in JAX's (row, col) order -> LayerNorm
    -> Linear 4C -> 2C without bias."""

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm = LayerNorm32(4 * dim, 1e-6, dtype=dtype)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        B, H, W, C = x.shape
        x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
        x = self.norm(x.reshape(B, H // 2, W // 2, 4 * C))
        return F.linear(x, self.reduction.weight.to(self.dtype))


class PatchEmbed(nn.Module):
    """4x4 stride-4 conv with flax's SAME padding, then LayerNorm."""

    def __init__(self, embed_dim: int, dtype=torch.float32):
        super().__init__()
        self.proj = Conv2d(3, embed_dim, 4, 4, dtype=dtype, same=True)
        self.norm = LayerNorm32(embed_dim, 1e-6, dtype=dtype)

    def forward(self, x):
        """NCHW image -> (B, H/4, W/4, C) tokens."""
        return self.norm(self.proj(x.contiguous(memory_format=CL))
                         .permute(0, 2, 3, 1))


class BasicLayer(nn.Module):
    """One stage: blocks with the shift on every second one, and the patch
    merging after them (None for the last stage)."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int, merge: bool, dtype=torch.float32):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dim, num_heads, window_size,
                      0 if j % 2 == 0 else window_size // 2, dtype=dtype)
            for j in range(depth)])
        self.downsample = PatchMerging(dim, dtype=dtype) if merge else None


class SwinTransformer(nn.Module):
    def __init__(self, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, dtype=torch.float32, remat=False):
        super().__init__()
        self.remat = bool(remat)
        self.patch_embed = PatchEmbed(embed_dim, dtype=dtype)
        self.layers = nn.ModuleList([
            BasicLayer(embed_dim * 2 ** i, d, num_heads[i], window_size,
                       i < len(depths) - 1, dtype=dtype)
            for i, d in enumerate(depths)])
        for i in range(1, len(depths)):
            self.add_module(f"norm{i}", LayerNorm32(
                embed_dim * 2 ** i, 1e-6, dtype=dtype))

    def forward(self, x):
        x = self.patch_embed(x)
        remat = self.remat and torch.is_grad_enabled()
        outs = []
        for i, layer in enumerate(self.layers):
            for block in layer.blocks:
                x = (checkpoint(block, x, use_reentrant=False) if remat
                     else block(x))
            if i >= 1:
                y = getattr(self, f"norm{i}")(x)
                outs.append(y.permute(0, 3, 1, 2))
            if layer.downsample is not None:
                x = layer.downsample(x)
        return tuple(outs)  # strides 8, 16, 32, NCHW views of NHWC maps


def swin_tiny(dtype=torch.float32, remat=False):
    return SwinTransformer(96, (2, 2, 6, 2), (3, 6, 12, 24), dtype=dtype,
                           remat=remat)


def swin_small(dtype=torch.float32, remat=False):
    return SwinTransformer(96, (2, 2, 18, 2), (3, 6, 12, 24), dtype=dtype,
                           remat=remat)


def swin_base(dtype=torch.float32, remat=False):
    return SwinTransformer(128, (2, 2, 18, 2), (4, 8, 16, 32), dtype=dtype,
                           remat=remat)


def swin_large(dtype=torch.float32, remat=False):
    return SwinTransformer(192, (2, 2, 18, 2), (6, 12, 24, 48), dtype=dtype,
                           remat=remat)


SWIN_BUILDERS = {"swin_tiny": swin_tiny, "swin_small": swin_small,
                 "swin_base": swin_base, "swin_large": swin_large}

SWIN_OUT_CHANNELS = {"swin_tiny_patch4_window7_224": (192, 384, 768),
                     "swin_tiny": (192, 384, 768),
                     "swin_small": (192, 384, 768),
                     "swin_base": (256, 512, 1024),
                     "swin_large": (384, 768, 1536)}
