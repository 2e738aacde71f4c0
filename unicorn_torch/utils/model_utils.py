"""Model analysis: parameter counts and FLOPs (port of
unicorn_tpu/utils/model_utils.py; the reference's unicorn/utils/
model_utils.py:19-28).

FLOPs are counted by torch.utils.flop_counter.FlopCounterMode, which counts
the matrix products and convolutions PyTorch runs (2 per multiply-add) and
no elementwise work. The hand-written kernels run outside PyTorch's
operators, so their call sites are counted from their shapes, as
chip_smoke.py's roofline counts them: the depthwise 7x7 conv 2 * 49 per
output element, MSDA 2 * 4 taps * D per sampling point, the correlation
2 * N * N * (C + K) a batch. Whatever a kernel's wrapper runs inside (its
plain version on the CPU) is not counted again, so the count is the same on
the card and on the CPU. The JAX package counts with XLA's cost analysis,
which counts the elementwise work as well.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.flop_counter import FlopCounterMode

from ..drivers import sot as _sot
from ..drivers import vos as _vos
from ..models import blocks as _blocks
from ..models import interaction as _interaction


def count_params(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def _dw7x7_ops(x, *_, **__):
    return 2 * 49 * x.numel()


def _msda_ops(value, locs, *_, **__):
    B, Lq, M, L, P, _ = locs.shape
    return 2 * B * Lq * M * L * P * 4 * value.shape[-1]


def _correlation_ops(e0, e1, v, *_, **__):
    B, N, C = e0.shape
    return 2 * B * N * N * (C + v.shape[1])


# (module, name of the kernel wrapper it calls, the wrapper's operations)
_KERNEL_SITES = ((_blocks, "dwconv7x7", _dw7x7_ops),
                 (_interaction, "ms_deform_attn", _msda_ops),
                 (_sot, "correlation_propagate_auto", _correlation_ops),
                 (_vos, "correlation_propagate_auto", _correlation_ops))


@contextlib.contextmanager
def _kernels_counted(tally: list):
    """Each kernel site adds its operations to tally[0] and runs with the
    flop counter switched off."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in
             _KERNEL_SITES]

    def counted(fn, ops):
        def call(*args, **kwargs):
            tally[0] += ops(*args, **kwargs)
            with _disable_current_modes():
                return fn(*args, **kwargs)
        return call

    try:
        for (mod, name, fn), (_, _, ops) in zip(saved, _KERNEL_SITES):
            setattr(mod, name, counted(fn, ops))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def count_flops(fn, *args, **kwargs) -> int:
    """The floating-point operations of fn(*args, **kwargs): PyTorch's
    matrix products and convolutions, and the port's kernels from their
    shapes."""
    tally = [0]
    with FlopCounterMode(display=False) as counter, \
            _kernels_counted(tally), torch.no_grad():
        fn(*args, **kwargs)
    return int(counter.get_total_flops()) + tally[0]


def get_model_info(model: torch.nn.Module, input_shape) -> str:
    """Parameters and GFLOPs of model(imgs) on zero images of input_shape
    (B, H, W, 3), as the JAX package gives the shape, e.g. (1, 800, 1280,
    3); the images go in as (B, 3, H, W) channels_last on the model's
    device."""
    n_params = count_params(model)
    B, H, W, C = input_shape
    p = next(model.parameters())
    imgs = torch.zeros(B, C, H, W, device=p.device).contiguous(
        memory_format=torch.channels_last)
    flops = count_flops(model, imgs)
    return (f"Params: {n_params / 1e6:.2f}M, "
            f"GFLOPs: {flops / 1e9:.2f} @ {H}x{W}")


def fuse_conv_norm(model):
    """The identity: the models normalise with GroupNorm and LayerNorm
    (per sample), which have no running statistics to fold into a conv as
    the reference's BatchNorm fusing does (model_utils.py:60-106)."""
    return model
