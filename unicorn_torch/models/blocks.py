"""YOLOX-family conv blocks and the ConvNeXt block, PyTorch.

Port of unicorn_tpu/models/blocks.py. Activations are NCHW tensors kept in
torch.channels_last memory, so `x.permute(0, 2, 3, 1)` is a contiguous NHWC
view at no cost. Parameters are fp32 and are cast to the module's compute
`dtype` at use, as flax does. Parameter names are those of the reference
torch model, so its state_dict keys line up (see unicorn_torch/convert.py).

Norms use PyTorch's mean-centred variance; flax computes E[x^2] - E[x]^2.
The two agree to fp32 rounding on these activations, which the parity
tests cover at atol 1e-4.

`set_fast_norms(True)` is the JAX package's serving switch of the same name
(unicorn_tpu/models/blocks.py:37): at the sites JAX honours it (every
GroupNorm32, the row split's too, the ConvNeXt block's LayerNorm and the
ConvNeXt trunk's stem, downsample and output LayerNorms; not the
interaction's or Swin's), a norm of a bf16 model takes its bf16 input
without an fp32 copy and writes bf16 rounded once from fp32 arithmetic, as
flax's `_normalize` does: fp32 sums of x and x^2 (flax's E[x^2] - E[x]^2),
the affine kept fp32. PyTorch's CUDA norms take no fp32 affine beside a
bf16 input, and its bf16 group_norm rounds its statistics to bf16, so
`group_norm_fast` and `layer_norm_fast` take the sums themselves and apply
the normalisation and the affine in addcmul's fp32 arithmetic, written
into a bf16 output. It changes nothing in an fp32 model.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.dwconv7x7 import dwconv7x7
from ..parallel import rows

CL = torch.channels_last
_TRUNC = 0.87962566103423978  # std of a standard normal truncated to [-2, 2]

_FAST_NORMS = False


def set_fast_norms(on: bool) -> None:
    """Serving switch (module docstring): the norms that honour it take a
    bf16 input without an fp32 copy. Off by default; read at every call."""
    global _FAST_NORMS
    _FAST_NORMS = bool(on)


def fast_norm(x: torch.Tensor, dtype) -> bool:
    """True when a norm of compute dtype `dtype` that honours the switch
    takes its fast form on x: the switch is on, dtype is not fp32, and x
    is already in dtype (an fp32 input has no copy to save)."""
    return _FAST_NORMS and dtype != torch.float32 and x.dtype == dtype


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax lecun_normal: truncated normal on [-2s, 2s], s = sqrt(1/fan_in)
    / 0.8796, fan_in = every axis but the output one."""
    std = math.sqrt(1.0 / w[0].numel()) / _TRUNC
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                              generator=generator)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise every parameter as the JAX package's flax init does (its
    distributions, not its random bits): lecun_normal kernels, zero biases,
    unit norm scales, and then each module's own rule
    (`_init_extra(generator)`: constants, or another distribution)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)) or getattr(m, "lecun", False):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                with torch.no_grad():
                    m.bias.zero_()
        elif isinstance(m, (GroupNorm32, LayerNorm32)):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.zero_()
    for m in module.modules():
        extra = getattr(m, "_init_extra", None)
        if extra is not None:
            extra(generator)


def get_activation(name: str = "silu"):
    if name == "silu":
        return F.silu
    if name == "relu":
        return F.relu
    if name == "lrelu":
        return lambda x: F.leaky_relu(x, negative_slope=0.1)
    if name == "gelu":
        return F.gelu
    raise ValueError(f"Unsupported act type: {name}")


class Conv2d(nn.Conv2d):
    """nn.Conv2d computed in `dtype` on fp32 params. same=True gives flax's
    'SAME' padding for a strided conv (the ConvNeXt 2x2/2 downsample)."""

    def __init__(self, in_ch, out_ch, ksize, stride=1, padding=0, groups=1,
                 bias=True, dtype=torch.float32, same=False):
        super().__init__(in_ch, out_ch, ksize, stride, padding, groups=groups,
                         bias=bias)
        self.dtype = dtype
        self.same = same

    def forward(self, x):
        dt = self.dtype
        plan = rows.active()
        padding = self.padding
        if self.same:
            # inside row_sharded the H pads come from the whole frame's
            # height, not from the block's
            hw = (plan.bounds(x.shape[2])[-1][1] if plan else x.shape[2],
                  x.shape[3])
            pads = []
            for n, k, s in zip(hw[::-1], self.kernel_size[::-1],
                               self.stride[::-1]):
                total = max((-(-n // s) - 1) * s + k - n, 0)
                pads += [total // 2, total - total // 2]
            if plan:
                padding = (pads[2], 0)
                pads[2:] = [0, 0]
            if any(pads):
                x = F.pad(x, pads)
        if plan:
            above, below = rows.window_rows(self.kernel_size[0],
                                            self.stride[0], padding[0])
            if above or below:
                x = rows.halo(x, above, below, 0.0, plan)
            padding = (0, padding[1])
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), b, self.stride,
                        padding, groups=self.groups)


def _sums(x: torch.Tensor, dims) -> torch.Tensor:
    """(2, ...) fp32 sums of x and x^2 over dims, read from x in its own
    dtype (no fp32 copy of x)."""
    return torch.stack([x.sum(dims, dtype=torch.float32),
                        torch.linalg.vector_norm(x, 2, dims,
                                                 dtype=torch.float32)
                        .square()])


def group_norm_fast(x: torch.Tensor, groups: int, weight: torch.Tensor,
                    bias: torch.Tensor, eps: float,
                    plan: rows.RowPlan | None = None) -> torch.Tensor:
    """GroupNorm of an NCHW (channels_last) map, written in x's dtype from
    fp32 statistics with an fp32 affine: each channel's sums of x and x^2
    in fp32 (summed over the plan's ranks under the row split, whose
    frame has every rank's rows), the groups' mean and variance as flax
    takes them (E[x^2] - E[x]^2, at least 0), then y = x * a + b with the
    per-channel fp32 a = rstd * weight and b = bias - mean * a (the form of
    PyTorch's own group_norm) in one addcmul."""
    N, C, H, W = x.shape
    per = C // groups
    s = _sums(x, (2, 3))
    if plan:
        rows.all_reduce(s, plan)
        H = plan.bounds(H)[-1][1]
    m = s.view(2, N, groups, per).sum(-1, keepdim=True) / (per * H * W)
    var = torch.addcmul(m[1], m[0], m[0], value=-1).clamp_min_(0.0)
    a = var.add_(eps).rsqrt_() * weight.view(groups, per)
    b = torch.addcmul(bias.view(groups, per), m[0], a, value=-1)
    return torch.addcmul(b.view(N, C, 1, 1), x, a.view(N, C, 1, 1),
                         out=torch.empty_like(x))


def layer_norm_fast(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over x's last axis, written in x's dtype from fp32
    statistics with an fp32 affine: the sums of x and x^2 in fp32, flax's
    E[x^2] - E[x]^2 (at least 0), then t = (x - mean) * rstd in fp32 and
    y = t * weight + bias, each one addcmul. PyTorch has no op that applies
    a per-row scale and a per-channel one at once, so t is the one fp32
    map of x's size; the exact form makes two (x's copy and its output)."""
    m = _sums(x, -1)[..., None] / x.shape[-1]
    var = torch.addcmul(m[1], m[0], m[0], value=-1).clamp_min_(0.0)
    rstd = var.add_(eps).rsqrt_()
    t = torch.addcmul(-m[0] * rstd, x, rstd)
    return torch.addcmul(bias, t, weight, out=torch.empty_like(x))


class GroupNorm32(nn.Module):
    """GroupNorm (16 groups, or C if fewer) normalising in fp32, eps 1e-3
    (the reference's BN->GN conversion keeps bn.eps); under set_fast_norms
    `group_norm_fast` on the bf16 input."""

    def __init__(self, channels: int, num_groups: int = 16,
                 dtype=torch.float32):
        super().__init__()
        self.groups = min(num_groups, channels)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.dtype = dtype

    def forward(self, x):
        plan = rows.active()
        fast = fast_norm(x, self.dtype)
        if fast:   # under the row split, over the whole frame too
            y = group_norm_fast(x, self.groups, self.weight, self.bias, 1e-3,
                                plan)
        elif plan:   # statistics over the whole frame, across the ranks
            y = rows.group_norm(x, self.groups, self.weight, self.bias, 1e-3,
                                plan)
        else:
            y = F.group_norm(x.float(), self.groups, self.weight, self.bias,
                             1e-3)
        return y.to(self.dtype, memory_format=CL)


class LayerNorm32(nn.Module):
    """LayerNorm over channels in fp32, output in `dtype`. channels_first:
    the input is NCHW (normalised over C through its NHWC view); otherwise
    the last axis is C. fast_norms: the site honours set_fast_norms (the
    ConvNeXt sites; the interaction's and Swin's stay fp32, as in JAX)."""

    def __init__(self, channels: int, eps: float = 1e-6, dtype=torch.float32,
                 channels_first: bool = False, fast_norms: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps
        self.dtype = dtype
        self.channels_first = channels_first
        self.fast_norms = fast_norms

    def forward(self, x):
        if self.channels_first:
            return self._ln(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return self._ln(x)

    def _ln(self, x):
        if self.fast_norms and fast_norm(x, self.dtype):
            return layer_norm_fast(x, self.weight, self.bias, self.eps)
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias,
                         self.eps)
        return y.to(self.dtype)


class BaseConv(nn.Module):
    """Conv2d -> GroupNorm -> act (reference BaseConv)."""

    def __init__(self, in_ch, out_ch, ksize=1, stride=1, groups=1, act="silu",
                 use_norm=True, bias=False, dtype=torch.float32):
        super().__init__()
        pad = (ksize - 1) // 2
        self.conv = Conv2d(in_ch, out_ch, ksize, stride, pad, groups=groups,
                           bias=bias or not use_norm, dtype=dtype)
        self.bn = GroupNorm32(out_ch, dtype=dtype) if use_norm else None
        self.act = get_activation(act)

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return self.act(x)


class DWConv(nn.Module):
    """Depthwise conv + pointwise conv (reference DWConv)."""

    def __init__(self, in_ch, out_ch, ksize, stride=1, act="silu",
                 dtype=torch.float32):
        super().__init__()
        self.dconv = BaseConv(in_ch, in_ch, ksize, stride, groups=in_ch,
                              act=act, dtype=dtype)
        self.pconv = BaseConv(in_ch, out_ch, 1, 1, act=act, dtype=dtype)

    def forward(self, x):
        return self.pconv(self.dconv(x))


class Bottleneck(nn.Module):
    def __init__(self, in_ch, out_ch, shortcut=True, expansion=0.5,
                 depthwise=False, act="silu", dtype=torch.float32):
        super().__init__()
        hidden = int(out_ch * expansion)
        self.conv1 = BaseConv(in_ch, hidden, 1, 1, act=act, dtype=dtype)
        conv = DWConv if depthwise else BaseConv
        self.conv2 = conv(hidden, out_ch, 3, 1, act=act, dtype=dtype)
        self.use_add = shortcut and in_ch == out_ch

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return y + x if self.use_add else y


class CSPLayer(nn.Module):
    """C3: CSP bottleneck with 3 convs."""

    def __init__(self, in_ch, out_ch, n=1, shortcut=True, expansion=0.5,
                 depthwise=False, act="silu", dtype=torch.float32):
        super().__init__()
        hidden = int(out_ch * expansion)
        self.conv1 = BaseConv(in_ch, hidden, 1, 1, act=act, dtype=dtype)
        self.conv2 = BaseConv(in_ch, hidden, 1, 1, act=act, dtype=dtype)
        self.conv3 = BaseConv(2 * hidden, out_ch, 1, 1, act=act, dtype=dtype)
        self.m = nn.Sequential(*[
            Bottleneck(hidden, hidden, shortcut, 1.0, depthwise, act=act,
                       dtype=dtype) for _ in range(n)])

    def forward(self, x):
        x1 = self.m(self.conv1(x))
        x2 = self.conv2(x)
        return self.conv3(torch.cat([x1, x2], dim=1))


class MaxPool2d(nn.MaxPool2d):
    """nn.MaxPool2d (square window, padding -inf); inside row_sharded the
    rows its window reads across the block's edges come from the other
    ranks, -inf beyond the frame's."""

    def forward(self, x):
        plan = rows.active()
        if not plan:
            return super().forward(x)
        k, s, p = self.kernel_size, self.stride, self.padding
        x = rows.halo(x, *rows.window_rows(k, s, p), float("-inf"), plan)
        return F.max_pool2d(x, k, s, (0, p))


class SPPBottleneck(nn.Module):
    """Spatial pyramid pooling: 1x1 conv to half width, the map beside its
    stride-1 max pools (5, 9, 13; padding -inf), 1x1 conv out."""

    def __init__(self, in_ch, out_ch, kernel_sizes=(5, 9, 13), act="silu",
                 dtype=torch.float32):
        super().__init__()
        hidden = in_ch // 2
        self.conv1 = BaseConv(in_ch, hidden, 1, 1, act=act, dtype=dtype)
        self.m = nn.ModuleList([MaxPool2d(ks, 1, ks // 2)
                                for ks in kernel_sizes])
        self.conv2 = BaseConv(hidden * (len(kernel_sizes) + 1), out_ch, 1, 1,
                              act=act, dtype=dtype)

    def forward(self, x):
        x = self.conv1(x)
        return self.conv2(torch.cat([x] + [m(x) for m in self.m], 1))


class Focus(nn.Module):
    """Space-to-depth stem: (B, C, H, W) -> (B, 4C, H/2, W/2) in the order
    top-left, bottom-left, top-right, bottom-right, then a BaseConv."""

    def __init__(self, in_ch, out_ch, ksize=1, stride=1, act="silu",
                 dtype=torch.float32):
        super().__init__()
        self.conv = BaseConv(4 * in_ch, out_ch, ksize, stride, act=act,
                             dtype=dtype)

    def forward(self, x):
        x = torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2],
                       x[..., ::2, 1::2], x[..., 1::2, 1::2]], 1)
        return self.conv(x.contiguous(memory_format=CL))


class DepthwiseConv7x7(nn.Module):
    """Depthwise 7x7 SAME conv + bias through ops.dwconv7x7: the CUDA kernel
    on the card, the plain version on the CPU. weight (C,1,7,7), bias (C,)
    as nn.Conv2d(C, C, 7, groups=C) keeps them."""

    lecun = True  # init_weights: lecun_normal weight, zero bias

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.dim = dim
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(dim, 1, 7, 7))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward_nhwc(self, x):
        """x NCHW -> (B,H,W,C) contiguous output. Inside row_sharded the
        kernel runs on the block and 3 halo rows each side, and the 3 rows
        at each end are cropped: no kept row reads the kernel's padding."""
        plan = rows.active()
        if plan:
            x = rows.halo(x, 3, 3, 0.0, plan)
        xn = x.to(self.dtype).contiguous(memory_format=CL).permute(0, 2, 3, 1)
        taps = self.weight.reshape(self.dim, 49).t().reshape(7, 7, self.dim)
        y = dwconv7x7(xn, taps, self.bias)
        return y[:, 3:-3] if plan else y

    def forward(self, x):
        return self.forward_nhwc(x).permute(0, 3, 1, 2)


class ConvNeXtBlock(nn.Module):
    """dw7x7 -> fp32 LayerNorm -> Linear C->4C -> GELU -> Linear 4C->C ->
    x gamma -> + residual. Used by the trunk and by the head's attention.
    Its fused alternative is the op `ops.convnext_block.convnext_block` on
    `block_params(self)`, which no model calls (as in the JAX package).

    `remat` (set by ConvNeXt on its trunk blocks) rematerialises the block
    while gradients are recorded: False keeps every activation; True keeps
    only the block's input and recomputes the whole block in the backward
    (the dw7x7 kernel launches again); "dw" keeps the dw7x7 output and
    recomputes the tail (`tail`), the residual add outside. The numbers
    are the same either way."""

    remat = False

    def __init__(self, dim: int, layer_scale_init_value: float = 1e-6,
                 dtype=torch.float32, exact_gelu: bool = True):
        super().__init__()
        self.dtype = dtype
        self.approximate = "none" if exact_gelu else "tanh"
        self.lsiv = layer_scale_init_value
        self.dwconv = DepthwiseConv7x7(dim, dtype=dtype)
        self.norm = LayerNorm32(dim, 1e-6, dtype=dtype, fast_norms=True)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = (nn.Parameter(torch.full((dim,), float(self.lsiv)))
                      if self.lsiv > 0 else None)

    def _init_extra(self, generator):
        if self.gamma is not None:
            with torch.no_grad():
                self.gamma.fill_(self.lsiv)

    def tail(self, y):
        """LayerNorm -> Linear -> GELU -> Linear -> x gamma of the dw7x7
        output (B, H, W, C)."""
        dt = self.dtype
        y = self.norm(y)
        y = F.linear(y, self.pwconv1.weight.to(dt), self.pwconv1.bias.to(dt))
        y = F.gelu(y, approximate=self.approximate)
        y = F.linear(y, self.pwconv2.weight.to(dt), self.pwconv2.bias.to(dt))
        if self.gamma is not None:
            y = y * self.gamma.to(dt)
        return y

    def _block(self, x, remat_tail=False):
        y = self.dwconv.forward_nhwc(x)
        y = (checkpoint(self.tail, y, use_reentrant=False) if remat_tail
             else self.tail(y))
        return x.to(self.dtype) + y.permute(0, 3, 1, 2)

    def forward(self, x):
        if not (self.remat and torch.is_grad_enabled()):
            return self._block(x)
        if self.remat == "dw":
            return self._block(x, remat_tail=True)
        return checkpoint(self._block, x, use_reentrant=False)


def upsample_nearest_2x(x):
    """Nearest-neighbour 2x upsampling of an NCHW (channels_last) tensor."""
    b, c, h, w = x.shape
    xn = x.permute(0, 2, 3, 1)
    xn = xn[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return xn.reshape(b, 2 * h, 2 * w, c).permute(0, 3, 1, 2)


def pixel_shuffle_2x(x):
    """PixelShuffle(2) of an NCHW tensor: (B, 4C, H, W) -> (B, C, 2H, 2W),
    input channel c*4 + dy*2 + dx going to output pixel (2y+dy, 2x+dx)."""
    return F.pixel_shuffle(x, 2)


def interpolate_bilinear(x, out_h: int, out_w: int):
    """Bilinear resize of an NCHW tensor, half-pixel centres, no
    antialiasing (F.interpolate with align_corners=False)."""
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=False, antialias=False)
