"""Synthetic video made on the device from a seed: a smooth random
background with filled rectangles ("objects") of random size and colour
that move at a constant velocity. The same seed gives the same pixels; every
seed gives the same number of objects, sizes drawn from the same range, so
the work does not change with the seed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _gen(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2 ** 63)
    return g


def _background(n, H, W, g, device):
    """(n, 3, H, W) float in [0, 255]: bilinear-upsampled coarse noise plus
    fine noise."""
    coarse = torch.rand(n, 3, max(H // 32, 2), max(W // 32, 2), generator=g,
                        device=device)
    bg = F.interpolate(coarse, size=(H, W), mode="bilinear",
                       align_corners=False) * 200.0 + 20.0
    return bg + torch.rand(n, 3, H, W, generator=g, device=device) * 30.0


def _draw(img, boxes, colours):
    """img (3, H, W) with boxes (K, 4) x1, y1, x2, y2 (pixels) filled with
    colours (K, 3)."""
    H, W = img.shape[1:]
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    for b, c in zip(boxes, colours):
        m = (xs >= b[0]) & (xs < b[2]) & (ys >= b[1]) & (ys < b[3])
        img = torch.where(m, c[:, None, None], img)
    return img


def object_tracks(n, K, steps, H, W, size_px, speed, g, device):
    """Boxes (n, steps, K, 4) cx, cy, w, h of K objects per sequence moving
    at `speed` px a step in a random direction, wrapped at the frame's
    edges, starting inside [0.15, 0.85] of the frame; colours (n, K, 3)."""
    lo, hi = size_px
    wh = lo + torch.rand(n, 1, K, 2, generator=g, device=device) * (hi - lo)
    wh = torch.minimum(wh, torch.tensor([W * 0.5, H * 0.5], device=device))
    c0 = (0.15 + 0.7 * torch.rand(n, 1, K, 2, generator=g, device=device)
          ) * torch.tensor([W, H], device=device)
    ang = torch.rand(n, 1, K, generator=g, device=device) * 6.283185307
    v = torch.stack([ang.cos(), ang.sin()], -1) * speed
    t = torch.arange(steps, device=device, dtype=torch.float32)[None, :,
                                                                 None, None]
    c = torch.remainder(c0 + t * v, torch.tensor([W, H], device=device))
    colours = torch.rand(n, K, 3, generator=g, device=device) * 255.0
    return torch.cat([c, wh.expand(n, steps, K, 2)], -1), colours


def video(n, steps, H, W, K, size_px, speed, seed, device):
    """(frames (n, steps, H, W, 3) uint8, boxes (n, steps, K, 4) cxcywh)."""
    g = _gen(seed, device)
    boxes, colours = object_tracks(n, K, steps, H, W, size_px, speed, g,
                                   device)
    bg = _background(n, H, W, g, device)
    out = torch.empty(n, steps, H, W, 3, dtype=torch.uint8, device=device)
    for i in range(n):
        for t in range(steps):
            img = bg[i]
            b = boxes[i, t]
            xyxy = torch.cat([b[:, :2] - b[:, 2:] / 2, b[:, :2] + b[:, 2:] / 2],
                             -1).round()
            img = _draw(img, xyxy, colours[i])
            out[i, t] = img.clamp(0, 255).round().to(torch.uint8).permute(
                1, 2, 0)
    return out, boxes
