"""Operand rounding of the reference: exact fp32, or the control's lower
precision.

Every product of the reference (convolution, linear, matmul) passes its
operands through a quantiser. The reference proper uses `exact`. The
control puts the reference in the program's place one precision below what
the configuration states: fp8 (e4m3, one scale a tensor) where the
configuration computes in bf16, bf16 where it computes in fp32. The rounding
is applied in the forward only; gradients pass through unchanged, as they
do through a cast.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def _straight_through(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    if x.requires_grad:
        return x + (q - x).detach()
    return q


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude maps to 448), returned in x's dtype."""
    xd = x.detach()
    scale = xd.abs().amax().float().clamp_min(1e-30) / E4M3_MAX
    q = (xd.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return _straight_through(x, q.to(x.dtype))


def bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, returned in x's dtype."""
    return _straight_through(x, x.detach().to(torch.bfloat16).to(x.dtype))


QUANTISERS = {"exact": exact, "fp8": fp8, "bf16": bf16}

# the control's step below each precision a configuration can state
BELOW = {"bf16": "fp8", "fp32": "bf16"}
