"""Label-map helpers (port of unicorn_tpu/utils/label_ops.py; the
reference's unicorn/utils/merge.py): one-hot conversion and label-map
resizing, and the palette-index mask reader."""
from __future__ import annotations

import torch

from ..data.image_io import read_indexed_mask
from ..losses.mask import resize_antialias

__all__ = ["convert_to_onehot", "adjust_labels_sz", "read_indexed_mask"]


def convert_to_onehot(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Hard one-hot of the argmax along `axis`, in x's dtype; ties go to the
    lowest index, as jnp.argmax (merge.py:18-23)."""
    idx = x.argmax(dim=axis, keepdim=True)
    return torch.zeros_like(x).scatter_(axis, idx, 1)


def adjust_labels_sz(lbs: torch.Tensor, dh: int, dw: int) -> torch.Tensor:
    """(F, K, H, W) label maps -> bilinear resize to (dh, dw), antialiased
    when it shrinks as jax.image.resize's "bilinear" is, then one-hot over
    K (merge.py:25-33)."""
    return convert_to_onehot(resize_antialias(lbs, dh, dw), axis=1)
