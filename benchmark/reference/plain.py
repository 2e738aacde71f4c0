"""The plain forms of the port's kernels that the reference model and loss
call: multi-scale deformable attention (a gather), label propagation by
embedding correlation (a streamed softmax), and the label-map helpers
around it. Frozen copies of `unicorn_torch/ops/deform_attn.py`
(`ms_deform_attn_plain`, direct mode) and `unicorn_torch/ops/correlation.py`,
in fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ms_deform_attn(value, locs, attw):
    """value (B,L,H,W,M,D); locs (B,Lq,M,L,P,2) in [0, 1] (x, y); attw
    (B,Lq,M,L,P) -> (B, Lq, M*D): bilinear samples, zero outside the map,
    weighted and summed, fp32."""
    B, L, H, W, M, D = value.shape
    Lq, P = locs.shape[1], locs.shape[4]
    x = locs[..., 0].float() * W - 0.5
    y = locs[..., 1].float() * H - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    lx, ly = x - x0, y - y0
    idx, wts = [], []
    for dy in (0, 1):
        for dx in (0, 1):
            cy, cx = y0 + dy, x0 + dx
            idx.append((cy.clamp(0, H - 1) * W + cx.clamp(0, W - 1)).long())
            w_c = (lx if dx else 1.0 - lx) * (ly if dy else 1.0 - ly)
            inside = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
            wts.append(torch.where(inside, w_c, torch.zeros_like(w_c))
                       * attw.float())
    idx, w = torch.stack(idx, -1), torch.stack(wts, -1)
    v = value.float().permute(0, 1, 4, 2, 3, 5).reshape(B, L, M, H * W, D)
    idx = idx.permute(0, 3, 2, 1, 4, 5).reshape(B, L, M, Lq * P * 4)
    g = torch.gather(v, 3, idx[..., None].expand(B, L, M, Lq * P * 4, D))
    g = g.reshape(B, L, M, Lq, P * 4, D)
    w = w.permute(0, 3, 2, 1, 4, 5).reshape(B, L, M, Lq, P * 4)
    out = torch.einsum("blmqkd,blmqk->bqmd", g, w)
    return out.reshape(B, Lq, M * D)


def correlation_propagate(embed0, embed1, lbs0, q=None, chunk: int = 1024):
    """out[b, k, j] = sum_i lbs0[b, k, i] softmax_i(e0[b, i] . e1[b, j]):
    embed0, embed1 (B, N, C), lbs0 (B, K, N) -> (B, K, N), fp32, streamed
    over chunks of target columns. `q` rounds the operands of both
    products."""
    q = q or (lambda t: t)
    e0 = q(embed0.float())
    lbs = lbs0.float()
    outs = []
    for e1_c in q(embed1.float()).split(chunk, dim=1):
        att = torch.softmax(torch.einsum("bmc,bnc->bmn", e1_c, e0), dim=2)
        outs.append(torch.einsum("bkn,bmn->bkm", q(lbs), q(att)))
    return torch.cat(outs, dim=2)


def box_label_map(boxes_cxcywh, H: int, W: int):
    """Boxes (B, 4) cxcywh -> binary maps (B, H, W), edges rounded half to
    even."""
    cx, cy, w, h = boxes_cxcywh.float().unbind(-1)
    x1 = torch.round(cx - 0.5 * w).to(torch.int32).clamp_min(0)
    y1 = torch.round(cy - 0.5 * h).to(torch.int32).clamp_min(0)
    x2 = torch.round(cx + 0.5 * w).to(torch.int32)
    y2 = torch.round(cy + 0.5 * h).to(torch.int32)
    xs = torch.arange(W, device=boxes_cxcywh.device)[None, None, :]
    ys = torch.arange(H, device=boxes_cxcywh.device)[None, :, None]
    inside = ((xs >= x1[:, None, None]) & (xs < x2[:, None, None])
              & (ys >= y1[:, None, None]) & (ys < y2[:, None, None]))
    return inside.float()


def resize_bilinear(x, out_h: int, out_w: int):
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=False, antialias=False)


def dice_loss(pred, gt, sample_mask):
    eps = 1e-5
    axes = tuple(range(1, pred.dim()))
    inter = (pred * gt).sum(axes) * sample_mask
    union = ((pred ** 2).sum(axes) + (gt ** 2).sum(axes)) * sample_mask
    return 1.0 - 2.0 * inter.sum() / (union.sum() + eps)
