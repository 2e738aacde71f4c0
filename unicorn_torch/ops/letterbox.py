"""Letterbox on the device, PyTorch (port of unicorn_tpu/ops/letterbox.py,
and the stand-in for the host cv2 letterbox of unicorn_tpu/data/preproc.py).

Frames go up as uint8 (3 bytes a pixel). The scale-preserving resize is
half-pixel bilinear without antialiasing (cv2.INTER_LINEAR), rounded to
uint8 as cv2's output is, then padded with 114 at the bottom and right.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import spanned


def letterbox_device(frame_u8: torch.Tensor, dst_hw):
    """frame_u8 (H, W, 3) uint8 -> ((dst_h, dst_w, 3) float32 with
    top-left content and 114 padding, scale r)."""
    if frame_u8.dtype != torch.uint8 or frame_u8.dim() != 3:
        raise ValueError(f"letterbox_device: expected (H, W, 3) uint8, got "
                         f"{tuple(frame_u8.shape)} {frame_u8.dtype}")
    sh, sw = frame_u8.shape[:2]
    return (letterbox_batch_device(frame_u8[None], dst_hw)[0],
            min(dst_hw[0] / sh, dst_hw[1] / sw))


@spanned("preprocess.letterbox")
def letterbox_batch_device(frames_u8: torch.Tensor, dst_hw) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, dst_h, dst_w, 3) float32: every frame
    letterboxed at the one scale their shared size gives (the batch form
    of unicorn_tpu/ops/letterbox.py:36)."""
    if frames_u8.dtype != torch.uint8 or frames_u8.dim() != 4:
        raise ValueError(f"letterbox_batch_device: expected (B, H, W, 3) "
                         f"uint8, got {tuple(frames_u8.shape)} "
                         f"{frames_u8.dtype}")
    B, sh, sw = frames_u8.shape[:3]
    dh, dw = dst_hw
    r = min(dh / sh, dw / sw)
    rh, rw = int(sh * r), int(sw * r)
    x = frames_u8.permute(0, 3, 1, 2).float()
    if (rh, rw) != (sh, sw):
        x = F.interpolate(x, size=(rh, rw), mode="bilinear",
                          align_corners=False, antialias=False)
        x = x.round_().clamp_(0, 255)
    out = torch.full((B, dh, dw, 3), 114.0, device=frames_u8.device)
    out[:, :rh, :rw] = x.permute(0, 2, 3, 1)
    return out


def letterbox_image(image: np.ndarray, dst_hw, device):
    """HWC uint8 frame on the host -> ((1, 3, dst_h, dst_w) float32 on
    `device`, a channels_last view, scale r). The frame goes up as uint8."""
    frame = torch.from_numpy(np.ascontiguousarray(image, np.uint8))
    img, r = letterbox_device(frame.to(device), dst_hw)
    return img.permute(2, 0, 1)[None], r
