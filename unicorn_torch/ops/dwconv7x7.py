"""Depthwise 7x7 'SAME' conv + bias, NHWC: the hand-written CUDA kernel
(csrc/dwconv7x7.cu) and its plain PyTorch version.

Port of `dwconv7x7_pallas` (unicorn_tpu/ops/pallas_convnext.py:196) and its
reference `dwconv7x7_ref` (:151). Semantics of the kernel: taps and bias are
rounded to the compute dtype first, the 49-tap sum is taken in fp32 and the
output is rounded once to the compute dtype. (The JAX reference form adds the
bias in the compute dtype, so in bf16 it rounds twice; fp32 is identical.)

`dwconv7x7` calls the registered op `unicorn_torch::dwconv7x7`
(torch.library), whose CUDA implementation launches the kernel and whose
CPU implementation is the plain version: the plain version runs only for a
tensor on the CPU. There is no fall-back: a CUDA tensor the kernel does not
take raises. The op's fake implementation gives torch.export the output's
shape, dtype and (contiguous) strides, so that an exported model keeps one
`unicorn_torch.dwconv7x7` node per call and launches the kernel when the
loaded program runs on the card.

Gradients: by default the op's registered backward is autograd of
`dwconv7x7_plain` on the saved (x, kdw, bias), as the JAX package's custom
VJP (`_dw_bwd`, pallas_convnext.py:305) recomputes through `dwconv7x7_ref`:
that package has no backward kernel for this op. The backward running the
plain version is the op's definition, not a fall-back from a kernel.

`set_dw_custom_vjp(True)` (the JAX package's training switch of the same
name, pallas_convnext.py:334) gives the op the restructured backward of
`dw_grads_restructured` (:341) instead, for every call whose forward runs
while it is on (the flag is read in the forward and kept with the saved
tensors): dx is this module's forward kernel on dy with the taps flipped
in both spatial axes and a zero bias (the plain version on the CPU), and
the filter and bias gradients are one call of the hand-written kernel
csrc/dw7x7_wgrad.cu (`dw7x7_wgrad`; its plain version on the CPU), fp32.
The forward, the op and its fake implementation are the same either way.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

# (H, W, C) of the dw7x7 calls of one 800x1280 frame of the MOT path (B=1),
# with how many blocks run at each: trunk stages 0-3, then the head's
# attention blocks at strides 8/16/32 (hidden 256)
PATH_SHAPES = (
    ((200, 320, 96), 3),
    ((100, 160, 192), 3),
    ((50, 80, 384), 9),
    ((25, 40, 768), 3),
    ((100, 160, 256), 3),
    ((50, 80, 256), 3),
    ((25, 40, 256), 3),
)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # channels per 16-byte vector

# kernel launches since the count was last set to 0 (read by chip_smoke.py);
# wgrad_launches counts the filter-gradient kernel's launches, two a call
# (the partial sums and their fixed-order sum)
launches = 0
wgrad_launches = 0

_DW_CUSTOM_VJP = False


def set_dw_custom_vjp(on: bool) -> None:
    """Training switch: the restructured backward (module docstring) for
    every dw7x7 call whose forward runs while it is on. Off by default;
    the forward is the same either way."""
    global _DW_CUSTOM_VJP
    _DW_CUSTOM_VJP = bool(on)


def _taps_bias(kdw: torch.Tensor, bias: torch.Tensor, C: int, dtype):
    """kdw (7,7,C) or (7,7,1,C), bias (C,) -> both rounded to `dtype`."""
    if kdw.dim() == 4:
        kdw = kdw[:, :, 0, :]
    if tuple(kdw.shape) != (7, 7, C) or tuple(bias.shape) != (C,):
        raise ValueError(f"dwconv7x7: taps {tuple(kdw.shape)} / bias "
                         f"{tuple(bias.shape)} do not match C={C}")
    return kdw.to(dtype), bias.to(dtype)


def dwconv7x7_plain(x: torch.Tensor, kdw: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x (B,H,W,C) -> (B,H,W,C) in x.dtype, with the
    kernel's rounding (dtype-rounded taps and bias, fp32 sum, one rounding).
    On the card, `torch.backends.cudnn.allow_tf32` must be False for this
    to be an fp32 sum."""
    dt = x.dtype
    C = x.shape[-1]
    kdw, bias = _taps_bias(kdw, bias, C, dt)
    w = kdw.float().permute(2, 0, 1).unsqueeze(1)          # (C,1,7,7)
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w, bias.float(),
                 padding=3, groups=C)
    return y.to(dt).permute(0, 2, 3, 1)


def pad_channels(op, x: torch.Tensor, kdw: torch.Tensor, bias: torch.Tensor,
                 multiple: int) -> torch.Tensor:
    """op(x, kdw, bias) with C zero-padded to a multiple of `multiple` (zero
    inputs, taps and bias in the padded channels) and the padded channels
    sliced off the output; op itself when C is a multiple already. A
    depthwise convolution keeps its channels apart, so the result is the
    unpadded op's. (The JAX kernel pads C to 128, pallas_convnext.py:223.)"""
    C = x.shape[-1]
    pad = -C % multiple
    if not pad:
        return op(x, kdw, bias)
    if kdw.dim() == 4:
        kdw = kdw[:, :, 0, :]
    y = op(F.pad(x, (0, pad)), F.pad(kdw, (0, pad)), F.pad(bias, (0, pad)))
    return y[..., :C].contiguous()


def _kernel(x: torch.Tensor, taps: torch.Tensor,
            bias: torch.Tensor) -> torch.Tensor:
    y = torch.empty_like(x)
    launch(x, taps.to(x.device).contiguous(), bias.to(x.device).contiguous(),
           y)
    return y


def dwconv7x7_cuda(x: torch.Tensor, kdw: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel on PyTorch's current stream. x must be a contiguous
    (B,H,W,C) CUDA tensor of float32 or bfloat16. The kernel reads 16-byte
    channel vectors (4 fp32, 8 bf16 channels): any other C is zero-padded
    to that multiple and sliced back (one copy each way); a C that is a
    multiple launches on x as it is."""
    if not x.is_cuda:
        raise ValueError("dwconv7x7_cuda: x is not a CUDA tensor")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"dwconv7x7_cuda: dtype {x.dtype} not supported")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("dwconv7x7_cuda: x must be a contiguous (B,H,W,C) "
                         f"tensor, got shape {tuple(x.shape)} strides "
                         f"{x.stride()}")
    kdw, bias = _taps_bias(kdw, bias, x.shape[-1], x.dtype)
    return pad_channels(_kernel, x, kdw, bias, _VEC[x.dtype])


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    from ..csrc import build

    lib = build.load("dwconv7x7")
    lib.dwconv7x7_nhwc.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                                   + [ctypes.c_void_p])
    lib.dwconv7x7_nhwc.restype = ctypes.c_int
    lib.dwconv7x7_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.dwconv7x7_plan.restype = ctypes.c_int
    lib.dwconv7x7_error_string.argtypes = [ctypes.c_int]
    lib.dwconv7x7_error_string.restype = ctypes.c_char_p
    return lib


def plan(B: int, H: int, W: int, C: int) -> dict:
    """The tiling the kernel's launcher picks for a (B,H,W,C) map on the
    current card: channel pairs and columns per block, rows per strip,
    strips per image and the grid."""
    out = (ctypes.c_int * 7)()
    err = _lib().dwconv7x7_plan(B, H, W, C, out)
    if err:
        raise ValueError(f"dwconv7x7 plan: no tiling for {(B, H, W, C)}")
    keys = ("pairs", "columns", "rows", "strips", "grid_x", "grid_y",
            "grid_z")
    return dict(zip(keys, list(out)))


def launch(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor,
           y: torch.Tensor) -> None:
    """One launch of the kernel into y, on arguments that dwconv7x7_cuda
    has checked and converted: x, y (B,H,W,C), taps (7,7,C), bias (C,), all
    contiguous CUDA tensors of one dtype."""
    global launches
    for t in (x, taps, bias, y):
        if t.data_ptr() % 16:
            raise ValueError("dwconv7x7_cuda: tensors must be 16-byte aligned")
    B, H, W, C = x.shape
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.dwconv7x7_nhwc(x.data_ptr(), taps.data_ptr(), bias.data_ptr(),
                             y.data_ptr(), B, H, W, C, _DTYPE_CODE[x.dtype],
                             stream)
    if err:
        raise RuntimeError(f"dwconv7x7 launch failed: {err} "
                           f"({lib.dwconv7x7_error_string(err).decode()}) at "
                           f"{(B, H, W, C)} {x.dtype}")
    launches += 1


def dw7x7_wgrad_plain(x: torch.Tensor, dy: torch.Tensor):
    """The filter and bias gradients of the dw7x7 SAME conv, as
    `dw_grads_restructured` takes them: x, dy (B,H,W,C) -> (dW (7,7,C),
    db (C,)), both fp32: 49 shifted multiply-reduce taps over the zero-padded
    fp32 input, and the sum of dy."""
    B, H, W, C = x.shape
    xp = F.pad(x.float(), (0, 0, 3, 3, 3, 3))
    dyf = dy.float()
    dk = torch.stack([torch.stack([
        (xp[:, u:u + H, v:v + W] * dyf).sum((0, 1, 2)) for v in range(7)])
        for u in range(7)])
    return dk, dyf.sum((0, 1, 2))


@functools.cache
def _wgrad_lib() -> ctypes.CDLL:
    """The built filter-gradient library with its C signatures declared."""
    from ..csrc import build

    lib = build.load("dw7x7_wgrad")
    lib.dw7x7_wgrad_nhwc.argtypes = ([ctypes.c_void_p] * 4
                                     + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.dw7x7_wgrad_nhwc.restype = ctypes.c_int
    lib.dw7x7_wgrad_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.dw7x7_wgrad_plan.restype = ctypes.c_int
    lib.dw7x7_wgrad_error_string.argtypes = [ctypes.c_int]
    lib.dw7x7_wgrad_error_string.restype = ctypes.c_char_p
    return lib


def wgrad_plan(B: int, H: int, W: int, C: int) -> dict:
    """The filter-gradient kernel's split of a (B,H,W,C) map on the current
    card: column tiles, channel slabs, bands an image, rows a band and
    workspace slots (partial sums of 50 x C floats each)."""
    out = (ctypes.c_int * 5)()
    if _wgrad_lib().dw7x7_wgrad_plan(B, H, W, C, out):
        raise ValueError(f"dw7x7_wgrad plan: bad shape {(B, H, W, C)}")
    return dict(zip(("tiles", "slabs", "bands", "rows", "slots"), list(out)))


def dw7x7_wgrad_cuda(x: torch.Tensor, dy: torch.Tensor):
    """The filter-gradient kernel on PyTorch's current stream: x, dy
    contiguous (B,H,W,C) CUDA tensors of one dtype (float32 or bfloat16),
    any C -> (dW (7,7,C), db (C,)) fp32. Two calls give the same bits."""
    global wgrad_launches
    if not (x.is_cuda and dy.is_cuda):
        raise ValueError("dw7x7_wgrad_cuda: x and dy must be CUDA tensors")
    if x.dtype not in _DTYPE_CODE or dy.dtype != x.dtype:
        raise TypeError(f"dw7x7_wgrad_cuda: dtypes {x.dtype} / {dy.dtype} "
                        "not supported (one of float32, bfloat16)")
    if (x.dim() != 4 or x.shape != dy.shape or not x.is_contiguous()
            or not dy.is_contiguous()):
        raise ValueError("dw7x7_wgrad_cuda: x and dy must be contiguous "
                         "(B,H,W,C) tensors of one shape, got "
                         f"{tuple(x.shape)} {x.stride()} / "
                         f"{tuple(dy.shape)} {dy.stride()}")
    B, H, W, C = x.shape
    slots = wgrad_plan(B, H, W, C)["slots"]
    ws = torch.empty(slots * 50 * C, dtype=torch.float32, device=x.device)
    out = torch.empty(50, C, dtype=torch.float32, device=x.device)
    lib = _wgrad_lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.dw7x7_wgrad_nhwc(x.data_ptr(), dy.data_ptr(), ws.data_ptr(),
                               out.data_ptr(), B, H, W, C,
                               _DTYPE_CODE[x.dtype], stream)
    if err:
        raise RuntimeError(f"dw7x7_wgrad launch failed: {err} "
                           f"({lib.dw7x7_wgrad_error_string(err).decode()})"
                           f" at {(B, H, W, C)} {x.dtype}")
    wgrad_launches += 2
    return out[:49].view(7, 7, C), out[49]


def dw7x7_wgrad(x: torch.Tensor, dy: torch.Tensor):
    """(dW (7,7,C), db (C,)) fp32 of the dw7x7 SAME conv: the kernel on
    CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cuda":
        return dw7x7_wgrad_cuda(x, dy)
    if x.device.type == "cpu":
        return dw7x7_wgrad_plain(x, dy)
    raise ValueError(f"dw7x7_wgrad: no kernel for device {x.device}")


def restructured_backward(inputs, needs, grad_out):
    """(dx, dkdw, dbias) of dwconv7x7(x, kdw, bias) for the inputs whose
    `needs` flag is set (None for the others), as `dw_grads_restructured`
    forms them: dx the forward kernel on grad_out with flipped taps and a
    zero bias, in grad_out's dtype; dkdw (kdw's shape) and dbias fp32 from
    one `dw7x7_wgrad` call. grad_out is used as it comes when it is
    contiguous in (B,H,W,C) order, and copied once otherwise."""
    x, kdw, bias = inputs
    g = grad_out.contiguous()
    dx = dk = db = None
    if needs[0]:
        taps = (kdw[:, :, 0, :] if kdw.dim() == 4 else kdw).flip(0, 1)
        conv = dwconv7x7_cuda if g.is_cuda else dwconv7x7_plain
        dx = conv(g, taps, torch.zeros_like(bias))
    if needs[1] or needs[2]:
        dw, dbias = dw7x7_wgrad(x.contiguous(), g)
        dk = dw.reshape(kdw.shape) if needs[1] else None
        db = dbias if needs[2] else None
    return dx, dk, db


def plain_backward(plain, inputs, needs, grad_out):
    """Gradients of plain(*inputs) against grad_out for the inputs whose
    `needs` flag is set (None for the others): the backward of an autograd
    Function whose forward kernel has no backward kernel."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        out = plain(*leaves)
        wanted = [t for t, n in zip(leaves, needs) if n]
        grads = iter(torch.autograd.grad(out, wanted, grad_out))
    return tuple(next(grads) if n else None for n in needs)


@torch.library.custom_op("unicorn_torch::dwconv7x7", mutates_args=(),
                         device_types="cuda")
def _dwconv7x7_op(x: torch.Tensor, kdw: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """The registered op on a CUDA tensor: the kernel on the tensors it was
    given (x is often an NHWC view of a channels_last map, contiguous in
    NHWC order)."""
    return dwconv7x7_cuda(x, kdw, bias)


@_dwconv7x7_op.register_kernel("cpu")
def _(x, kdw, bias):
    return dwconv7x7_plain(x, kdw, bias).contiguous()


@_dwconv7x7_op.register_fake
def _(x, kdw, bias):
    # both implementations return a fresh contiguous (B,H,W,C) tensor in
    # x's dtype, so that a traced graph sees the strides a run gives
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)
    ctx.restructured = _DW_CUSTOM_VJP


def _backward(ctx, grad_out):
    """The restructured backward if the flag was on at the forward, else
    autograd of dwconv7x7_plain on the saved (x, kdw, bias), reaching x
    and the fp32 taps and bias."""
    if ctx.restructured:
        return restructured_backward(ctx.saved_tensors,
                                     ctx.needs_input_grad, grad_out)
    return plain_backward(dwconv7x7_plain, ctx.saved_tensors,
                          ctx.needs_input_grad, grad_out)


_dwconv7x7_op.register_autograd(_backward, setup_context=_setup_context)


def dwconv7x7(x: torch.Tensor, kdw: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """Depthwise 7x7 SAME conv + bias. x (B,H,W,C); kdw (7,7,C) or
    (7,7,1,C); bias (C,). The op `unicorn_torch::dwconv7x7`: the kernel on
    a CUDA tensor, the plain version on a CPU tensor; differentiable, the
    backward autograd of the plain version (the restructured one under
    `set_dw_custom_vjp`); traceable by torch.export."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"dwconv7x7: no kernel for device {x.device}")
    return _dwconv7x7_op(x, kdw, bias)
