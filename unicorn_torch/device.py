"""Device resolution for the port's entry points, and the evaluators' moves
of host images to the device and of results back."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """Entry points default to the card. A CUDA device that is not there is
    an error, never a silent fall-back to the CPU: callers that want the CPU
    (the tests) ask for it with device="cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev


def images_to_device(images: np.ndarray, device: torch.device):
    """(B, H, W, 3) float32 images on the host -> (B, 3, H, W) on `device`,
    a channels_last view of the NHWC data; copied through page-locked
    memory to the card."""
    t = torch.from_numpy(np.ascontiguousarray(images, np.float32))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True).permute(0, 3, 1, 2)


def to_host(x) -> np.ndarray:
    """A tensor (bf16 / fp16 widened to fp32) or array -> numpy."""
    if isinstance(x, torch.Tensor):
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.detach().cpu().numpy()
    return np.asarray(x)
