"""CondInst dynamic-convolution mask head as batched matmuls, PyTorch (port
of unicorn_tpu/ops/dynamic_conv.py).

The per-instance 3-layer 1x1 dynamic convs run for a fixed instance axis N
at once, as einsums over (N, H*W, C). The parameter vector's layout is the
reference's: weights [80, 64, 8] then biases [8, 8, 1], each weight block
stored (out, in) row-major.

Maps are NCHW (the port's layout): mask features (C, H, W) of one image,
the RAFT up-mask (9*R*R, H, W); `dynamic_mask_logits` and
`convex_upsample` also take a leading batch dim, where the JAX package
vmaps them over images. `resize_align_corners` and `aligned_bilinear` take
(N, H, W) or (N, C, H, W).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

MASK_CHANNELS = 8
WEIGHT_NUMS = ((MASK_CHANNELS + 2) * MASK_CHANNELS,  # 80: (8 feat + 2 coord) -> 8
               MASK_CHANNELS * MASK_CHANNELS,        # 64
               MASK_CHANNELS * 1)                    # 8
BIAS_NUMS = (MASK_CHANNELS, MASK_CHANNELS, 1)
NUM_GEN_PARAMS = sum(WEIGHT_NUMS) + sum(BIAS_NUMS)   # 169
SIZES_OF_INTEREST = (64, 128, 256, 512, 1024)


def parse_dynamic_params(params):
    """params (..., N, 169) -> ([w0 (..., N,10,8), w1 (..., N,8,8),
    w2 (..., N,8,1)], [b0 (..., N,8), b1 (..., N,8), b2 (..., N,1)]), the
    weights transposed to (in, out) for x @ w."""
    lead = params.shape[:-1]
    splits = torch.split(params, WEIGHT_NUMS + BIAS_NUMS, dim=-1)
    in_chs = (MASK_CHANNELS + 2, MASK_CHANNELS, MASK_CHANNELS)
    out_chs = (MASK_CHANNELS, MASK_CHANNELS, 1)
    weights = [splits[i].reshape(*lead, out_chs[i], in_chs[i])
               .transpose(-1, -2) for i in range(3)]
    biases = [splits[3 + i].reshape(*lead, out_chs[i]) for i in range(3)]
    return weights, biases


def compute_locations(h: int, w: int, stride: int, device=None):
    """(h*w, 2) pixel-centre (x, y) locations of a stride-`stride` map."""
    xs = torch.arange(w, dtype=torch.float32, device=device) * stride \
        + stride // 2
    ys = torch.arange(h, dtype=torch.float32, device=device) * stride \
        + stride // 2
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], 1)


def dynamic_mask_logits(mask_feats, params, instance_locations,
                        instance_fpn_levels, mask_feat_stride: int = 8):
    """The 3-layer dynamic head for N instances at once, in fp32.

    mask_feats: (..., C=8, H, W); params: (..., N, 169);
    instance_locations: (..., N, 2) image coords; instance_fpn_levels:
    (..., N) int. The leading dims (none for one image, B for a batch) are
    the images'. Returns logits (..., N, H, W).
    """
    *lead, C, H, W = mask_feats.shape
    N = params.shape[-2]
    dev = mask_feats.device
    locations = compute_locations(H, W, mask_feat_stride, dev)   # (HW, 2)
    rel = instance_locations[..., None, :].float() - locations
    soi = torch.tensor(SIZES_OF_INTEREST, dtype=torch.float32, device=dev)[
        instance_fpn_levels.long().clamp(0, len(SIZES_OF_INTEREST) - 1)]
    rel = rel / soi[..., None, None]
    feat = mask_feats.float().reshape(*lead, 1, C, H * W).transpose(-1, -2)
    x = torch.cat([rel, feat.expand(*lead, N, H * W, C)], -1)  # (.., N, HW, 10)
    weights, biases = parse_dynamic_params(params.float())
    for i, (w, b) in enumerate(zip(weights, biases)):
        x = torch.matmul(x, w) + b[..., None, :]
        if i < 2:
            x = F.relu(x)
    return x.reshape(*lead, N, H, W)


def _as_nchw(x):
    """(N, H, W) or (N, C, H, W) -> (NCHW tensor, whether it was 3-D)."""
    return (x[:, None], True) if x.dim() == 3 else (x, False)


def resize_align_corners(x, out_h: int, out_w: int):
    """Bilinear resize with align_corners=True of (N, H, W) or (N, C, H,
    W)."""
    x, squeeze = _as_nchw(x)
    y = F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                      align_corners=True)
    return y[:, 0] if squeeze else y


def aligned_bilinear(x, factor: int):
    """Edge-pad one row and column, align_corners resize to factor*h + 1,
    edge-pad factor // 2 at the top and left, crop to factor * (h, w): the
    reference CondInst upsample. x (N, H, W) or (N, C, H, W)."""
    if factor == 1:
        return x
    x, squeeze = _as_nchw(x)
    h, w = x.shape[-2:]
    x = F.pad(x, (0, 1, 0, 1), mode="replicate")
    oh, ow = factor * h + 1, factor * w + 1
    x = resize_align_corners(x, oh, ow)
    pad = factor // 2
    x = F.pad(x, (pad, 0, pad, 0), mode="replicate")[..., :oh - 1, :ow - 1]
    return x[:, 0] if squeeze else x


def convex_upsample(pred, up_mask, up_rate: int = 8):
    """RAFT convex-combination upsampling. pred: (..., N, H, W) logits;
    up_mask: (..., 9*R*R, H, W) from the mask branch (the same leading
    dims: none for one image, B for a batch), whose softmax over the 9
    neighbours runs in up_mask's dtype, as JAX's does. Returns
    (..., N, R*H, R*W)."""
    *lead, N, H, W = pred.shape
    R = up_rate
    m = torch.softmax(up_mask.reshape(*lead, 9, R, R, H, W), -5)
    # 3x3 neighbourhoods of pred, zero-padded (F.unfold's order: dy, dx)
    p = F.pad(pred, (1, 1, 1, 1))
    patches = torch.stack([p[..., dy:dy + H, dx:dx + W]
                           for dy in range(3) for dx in range(3)], -3)
    up = torch.einsum("...nkhw,...krshw->...nrshw", patches,
                      m.to(torch.promote_types(m.dtype, patches.dtype)))
    L = len(lead)
    return up.permute(*range(L), L, L + 3, L + 1, L + 4, L + 2).reshape(
        *lead, N, H * R, W * R)
