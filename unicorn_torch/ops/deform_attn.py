"""Multi-scale deformable attention sampling: the hand-written CUDA gather
kernel (csrc/msda.cu) and its plain PyTorch versions.

Port of `ms_deform_attn` (unicorn_tpu/ops/deform_attn.py:100) and of the two
Pallas kernels it reaches: `_msda_pallas_factored` (:294, kernel mode
"factored") and `_msda_pallas` (:204, kernel mode "direct"). All compute

    out[b, q, m, :] = sum_{l, p} sum_{4 corners} w * value[b, l, cy, cx, m, :]

with x = loc_x * W - 0.5, y = loc_y * H - 0.5 and corners outside the map
contributing zero (F.grid_sample: bilinear, zeros, align_corners=False). The
sum is taken in fp32 and rounded once to the value's dtype T. The modes
differ in where T (bf16) rounds the corner weight w:

  factored  the fractions lx, ly are rounded to T; the per-axis weights
            (1 - frac, frac; zero outside) are in T; the y weight times the
            attention weight is in T; w = round_T(fp32 wy * wx).
  direct    w = round_T((x term * y term) * attention weight), all in fp32.

In fp32 the two agree up to the association of the three factors. One known
difference from the Pallas kernels: they round the SUM of the weights that
land on one cell (deform_attn.py:250-256, :386), a gather rounds each tap's
weight. It shows only where two taps of one (query, head, level) hit the
same cell, and only in bf16.

`ms_deform_attn` launches the kernel for a CUDA tensor and takes a plain
version only for a tensor on the CPU; a CUDA tensor the kernel does not take
raises.

Gradients: on a CUDA tensor the op is an autograd Function whose forward is
the kernel (fp32 in training, where the interaction is fp32) and whose
backward is autograd of the plain gather in the kernel's mode, giving dvalue,
dlocations and dweights. The JAX package's custom VJPs
(`_msda_pallas_factored_bwd`, `_msda_pallas_bwd`, deform_attn.py:428, :449)
likewise recompute through a non-kernel form and it has no backward kernel,
so the port has none either: the plain backward is the op's definition, not a
fall-back from a kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..utils.profiling import span
from .dwconv7x7 import plain_backward

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}   # channels per 16-byte vector
_MODE_CODE = {"factored": 0, "direct": 1}
# the JAX package's method names -> (kernel mode, plain mode on the CPU)
_METHOD_MODE = {"auto": ("factored", "direct"),
                "pallas_factored": ("factored", "factored"),
                "pallas": ("direct", "direct")}

# kernel launches since the counts were last set to 0 (read by chip_smoke.py):
# the total, and the same launches by kernel mode
launches = 0
launches_by_mode = {"factored": 0, "direct": 0}


def _check_shapes(value, locs, attw):
    if value.dim() != 6 or locs.dim() != 6 or attw.dim() != 5:
        raise ValueError(
            "ms_deform_attn: expected value (B,L,H,W,M,D), locations "
            f"(B,Lq,M,L,P,2), weights (B,Lq,M,L,P); got {tuple(value.shape)}, "
            f"{tuple(locs.shape)}, {tuple(attw.shape)}")
    B, L, H, W, M, D = value.shape
    Lq, P = locs.shape[1], locs.shape[4]
    if tuple(locs.shape) != (B, Lq, M, L, P, 2) or \
            tuple(attw.shape) != (B, Lq, M, L, P):
        raise ValueError(
            f"ms_deform_attn: locations {tuple(locs.shape)} / weights "
            f"{tuple(attw.shape)} do not match value {tuple(value.shape)} "
            "in B, M or L")
    if locs.dtype != torch.float32:
        raise TypeError("ms_deform_attn: sampling locations must be float32, "
                        f"got {locs.dtype}")


def corner_taps(locs, attw, H: int, W: int, dtype, mode: str):
    """Locations (B,Lq,M,L,P,2) fp32 and weights (B,Lq,M,L,P) -> (cell index
    (B,Lq,M,L,P,4) int64 into the flattened H*W map, clamped; corner weight
    (B,Lq,M,L,P,4) in `dtype`), corners in the order (y0,x0), (y0,x1),
    (y1,x0), (y1,x1), with the rounding of `mode`."""
    x = locs[..., 0] * W - 0.5
    y = locs[..., 1] * H - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    lx, ly = x - x0, y - y0
    cells = [(y0 + dy, x0 + dx) for dy in (0, 1) for dx in (0, 1)]
    idx = torch.stack([(cy.clamp(0, H - 1) * W + cx.clamp(0, W - 1)).long()
                       for cy, cx in cells], -1)
    zero = torch.zeros((), dtype=torch.float32, device=locs.device)
    if mode == "direct":
        wts = []
        for (cy, cx), (dy, dx) in zip(cells, ((0, 0), (0, 1), (1, 0), (1, 1))):
            w_c = (lx if dx else 1.0 - lx) * (ly if dy else 1.0 - ly)
            inside = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
            wts.append(torch.where(inside, w_c, zero) * attw.float())
        return idx, torch.stack(wts, -1).to(dtype)
    if mode != "factored":
        raise ValueError(f"unknown mode {mode!r}")

    def axis(c0, frac, n):
        frac = frac.to(dtype)
        z = zero.to(dtype)
        lo = torch.where((c0 >= 0) & (c0 < n), 1.0 - frac, z)
        hi = torch.where((c0 + 1 >= 0) & (c0 + 1 < n), frac, z)
        return torch.stack([lo, hi], -1)                   # (..., 2) in dtype

    wy = axis(y0, ly, H) * attw[..., None].to(dtype)
    wx = axis(x0, lx, W)
    w = (wy[..., :, None].float() * wx[..., None, :].float()).to(dtype)
    return idx, w.reshape(*w.shape[:-2], 4)


def ms_deform_attn_plain(value, locs, attw, mode: str = "direct"):
    """Plain PyTorch version (a gather), with the kernel's arithmetic in
    `mode`: weights rounded as the mode says, an fp32 sum, one rounding to
    value.dtype. value (B,L,H,W,M,D); locs (B,Lq,M,L,P,2) fp32; attw
    (B,Lq,M,L,P) -> (B, Lq, M*D). On the card,
    `torch.backends.cuda.matmul.allow_tf32` must be False for the sum to be
    an fp32 one."""
    _check_shapes(value, locs, attw)
    B, L, H, W, M, D = value.shape
    Lq, P = locs.shape[1], locs.shape[4]
    idx, w = corner_taps(locs, attw, H, W, value.dtype, mode)
    v = value.permute(0, 1, 4, 2, 3, 5).reshape(B, L, M, H * W, D)
    idx = idx.permute(0, 3, 2, 1, 4, 5).reshape(B, L, M, Lq * P * 4)
    g = torch.gather(v, 3, idx[..., None].expand(B, L, M, Lq * P * 4, D))
    g = g.reshape(B, L, M, Lq, P * 4, D)
    w = w.permute(0, 3, 2, 1, 4, 5).reshape(B, L, M, Lq, P * 4)
    out = torch.einsum("blmqkd,blmqk->bqmd", g.float(), w.float())
    return out.to(value.dtype).reshape(B, Lq, M * D)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    from ..csrc import build

    lib = build.load("msda")
    lib.msda_forward.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
                                 + [ctypes.c_void_p])
    lib.msda_forward.restype = ctypes.c_int
    lib.msda_error_string.argtypes = [ctypes.c_int]
    lib.msda_error_string.restype = ctypes.c_char_p
    return lib


def launch(value, locs, attw, out, mode: str) -> None:
    """One launch of the kernel into out (B,Lq,M*D), on arguments that
    ms_deform_attn_cuda has checked."""
    global launches
    B, L, H, W, M, D = value.shape
    Lq, P = locs.shape[1], locs.shape[4]
    lib = _lib()
    stream = torch.cuda.current_stream(value.device).cuda_stream
    err = lib.msda_forward(
        value.data_ptr(), locs.data_ptr(), attw.data_ptr(), out.data_ptr(),
        B, L, H, W, M, D, Lq, P, _DTYPE_CODE[value.dtype],
        _DTYPE_CODE[attw.dtype], _MODE_CODE[mode], stream)
    if err:
        raise RuntimeError(
            f"msda launch failed: {err} ({lib.msda_error_string(err).decode()})"
            f" at value {tuple(value.shape)} {value.dtype}, Lq={Lq}, P={P}")
    launches += 1
    launches_by_mode[mode] += 1


def ms_deform_attn_cuda(value, locs, attw, mode: str = "factored"):
    """The CUDA kernel on PyTorch's current stream. value: contiguous
    (B,L,H,W,M,D) CUDA tensor, float32 or bfloat16; locs: contiguous
    float32; attw: contiguous float32 or bfloat16. The kernel reads 16-byte
    channel vectors (4 fp32, 8 bf16 channels): any other D is zero-padded
    to that multiple and sliced back (`pad_head_width`); a D that is a
    multiple launches on value as it is. Autograd does not see this launch;
    `ms_deform_attn` wraps it in a Function."""
    if mode not in _MODE_CODE:
        raise ValueError(f"ms_deform_attn_cuda: unknown mode {mode!r}")
    _check_shapes(value, locs, attw)
    for name, t in (("value", value), ("locations", locs), ("weights", attw)):
        if not t.is_cuda or t.device != value.device:
            raise ValueError(f"ms_deform_attn_cuda: {name} is not on the "
                             f"value's CUDA device ({t.device})")
        if not t.is_contiguous():
            raise ValueError(f"ms_deform_attn_cuda: {name} is not contiguous "
                             f"(shape {tuple(t.shape)}, strides {t.stride()})")
    if value.dtype not in _DTYPE_CODE or attw.dtype not in _DTYPE_CODE:
        raise TypeError(f"ms_deform_attn_cuda: value {value.dtype} / weights "
                        f"{attw.dtype} must be float32 or bfloat16")
    return pad_head_width(lambda v, l, a: _kernel(v, l, a, mode), value, locs,
                          attw, _VEC[value.dtype])


def pad_head_width(op, value, locs, attw, multiple: int):
    """op(value, locs, attw) -> (B, Lq, M*D) with the head width D
    zero-padded to a multiple of `multiple` and the padded channels sliced
    off the output; op itself when D is a multiple already. Each channel
    is sampled on its own, so the result is the unpadded op's."""
    D = value.shape[-1]
    pad = -D % multiple
    if not pad:
        return op(value, locs, attw)
    out = op(F.pad(value, (0, pad)), locs, attw)
    B, Lq = out.shape[:2]
    return out.reshape(B, Lq, -1, D + pad)[..., :D].reshape(B, Lq, -1)


def _kernel(value, locs, attw, mode):
    B, Lq, M = locs.shape[:3]
    D = value.shape[-1]
    out = torch.empty((B, Lq, M * D), dtype=value.dtype, device=value.device)
    if value.data_ptr() % 16 or out.data_ptr() % 16 or locs.data_ptr() % 8:
        raise ValueError("ms_deform_attn_cuda: value and output rows are read "
                         "and written as 16-byte vectors, locations as 8-byte "
                         "pairs, and must be aligned so")
    if out.numel():
        launch(value, locs, attw, out, mode)
    return out


class _MSDeformAttn(torch.autograd.Function):
    """forward = the gather kernel in `mode`; backward = autograd of
    ms_deform_attn_plain in the same mode."""

    @staticmethod
    def forward(ctx, value, locs, attw, mode):
        ctx.save_for_backward(value, locs, attw)
        ctx.mode = mode
        with span("op.ms_deform_attn"):
            return ms_deform_attn_cuda(value, locs, attw, mode)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        mode = ctx.mode
        with span("op.ms_deform_attn.bwd"):
            return plain_backward(
                lambda v, l, a: ms_deform_attn_plain(v, l, a, mode),
                ctx.saved_tensors, ctx.needs_input_grad[:3],
                grad_out) + (None,)


def ms_deform_attn(value, locs, attw, method: str = "auto"):
    """Deformable attention aggregation over L equal-shape levels.

    value (B,L,H,W,M,D); locs (B,Lq,M,L,P,2) normalised (x, y), float32;
    attw (B,Lq,M,L,P), already softmaxed over L*P. Returns (B, Lq, M*D).

    method, with the JAX package's names: "pallas_factored" is the kernel's
    factored mode and "pallas" its direct mode (the kernel on a CUDA tensor,
    that mode's plain version on a CPU tensor; differentiable, with the
    plain version's backward); "auto" is the factored
    kernel on a CUDA tensor and the plain gather on a CPU tensor, as the
    JAX package takes its gather off the TPU; "gather" is the plain direct
    form on any device. "onehot" and "onehot_factored" are XLA formulations
    for a chip without a gather; they have no counterpart here and raise."""
    if method in ("onehot", "onehot_factored"):
        raise NotImplementedError(
            f"ms_deform_attn(method={method!r}) is an XLA one-hot matmul "
            "formulation for the TPU; the port has the gather kernel "
            "('auto', 'pallas_factored', 'pallas') and 'gather'")
    if method == "gather":
        return ms_deform_attn_plain(value, locs, attw, "direct")
    if method not in _METHOD_MODE:
        raise ValueError(f"unknown MSDA method {method!r}; expected one of "
                         f"{sorted(_METHOD_MODE) + ['gather']}")
    kernel_mode, cpu_mode = _METHOD_MODE[method]
    if value.is_cuda:
        return _MSDeformAttn.apply(value, locs, attw, kernel_mode)
    if value.device.type != "cpu":
        raise ValueError(f"ms_deform_attn: no kernel for device {value.device}")
    return ms_deform_attn_plain(value, locs, attw, cpu_mode)
