"""One whole ConvNeXt block as an op, NHWC: the hand-written CUDA kernel
(csrc/convnext_block.cu), its plain PyTorch version and the reference
composition.

Port of `convnext_block` (unicorn_tpu/ops/pallas_convnext.py:388), its kernel
`convnext_block_pallas` (:54) and its reference `convnext_block_ref` (:22).
As in the JAX package no model calls the op: `models.blocks.ConvNeXtBlock`
composes the block from the dw7x7 kernel, LayerNorm and two linear layers,
and this op is its fused alternative.

    y = x + gamma * (W2 . gelu(W1 . LN(dwconv7x7(x) + b_dw) + b1) + b2)

`x` is (B,H,W,C); `p` is a dict under the port's parameter names,
    {"dwconv": {"weight" (C,1,7,7), "bias" (C,)},
     "norm": {"weight" (C,), "bias" (C,)},
     "pwconv1": {"weight" (4C,C), "bias" (4C,)},
     "pwconv2": {"weight" (C,4C), "bias" (C,)}, "gamma" (C,)},
which `block_params` takes from a ConvNeXtBlock module and
`convert.convnext_block_params` from the flax sub-tree.

Three forms, which differ in where they round when x is bf16:
- `convnext_block_ref`: the composition, equal to the ConvNeXtBlock module:
  every parameter is rounded to x.dtype, and so are the conv output, the
  LayerNorm output, each linear layer's output, the GELU and gamma * y.
- the kernel and `convnext_block_plain`, as the TPU kernel's body: the dw
  taps and bias, the LayerNorm scale and bias, b1, b2 and gamma stay fp32;
  only W1 and W2 are rounded; the 49-tap fp32 sum goes into LayerNorm
  unrounded; yn is rounded once; product 1 + b1 and the GELU are fp32, then
  one rounding; product 2 + b2, x gamma, + the residual are fp32, then one
  rounding. The variance is the two-pass form mean((acc - mu)^2) in both (the
  TPU body takes E[x^2] - mu^2).
In fp32 the three agree to summation order.

`convnext_block(x, p, exact_gelu, method)`: "auto" launches the kernel for a
CUDA tensor and takes the plain version only for a tensor on the CPU;
"pallas" (the JAX package's name for the kernel route) is the kernel and
raises for a CPU tensor; "ref" is the composition. There is no fall-back: a
CUDA tensor the kernel does not take raises.

Gradients: "auto" and "pallas" go through an autograd Function whose forward
is the kernel (the plain version on the CPU) and whose backward is autograd
of `convnext_block_ref` on the saved (x, p), as the JAX package's custom VJP
(`_make_vjp`, pallas_convnext.py:400) recomputes through its reference: that
package has no backward kernel for this op, so the port has none either. The
backward running the composition is the op's definition, not a fall-back
from a kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .dwconv7x7 import dwconv7x7_plain, plain_backward

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # channels per 16-byte vector

# the leaves of p in the order the autograd Function takes them
LEAVES = (("dwconv", "weight"), ("dwconv", "bias"), ("norm", "weight"),
          ("norm", "bias"), ("pwconv1", "weight"), ("pwconv1", "bias"),
          ("pwconv2", "weight"), ("pwconv2", "bias"), ("gamma",))

# op calls that launched the kernels since the count was last set to 0 (read
# by chip_smoke.py); one call launches the four kernels of one block
launches = 0


def block_params(block) -> dict:
    """The parameter dict `p` of a models.blocks.ConvNeXtBlock (its own
    tensors, not copies). A block without layer scale gets gamma = 1."""
    gamma = block.gamma
    if gamma is None:
        gamma = torch.ones_like(block.norm.weight)
    return {
        "dwconv": {"weight": block.dwconv.weight, "bias": block.dwconv.bias},
        "norm": {"weight": block.norm.weight, "bias": block.norm.bias},
        "pwconv1": {"weight": block.pwconv1.weight,
                    "bias": block.pwconv1.bias},
        "pwconv2": {"weight": block.pwconv2.weight,
                    "bias": block.pwconv2.bias},
        "gamma": gamma,
    }


def flatten_params(p: dict) -> tuple:
    """p -> its nine tensors in the order of LEAVES."""
    return tuple(p[k[0]] if len(k) == 1 else p[k[0]][k[1]] for k in LEAVES)


def unflatten_params(leaves) -> dict:
    p: dict = {}
    for k, t in zip(LEAVES, leaves):
        if len(k) == 1:
            p[k[0]] = t
        else:
            p.setdefault(k[0], {})[k[1]] = t
    return p


def _check(x: torch.Tensor, leaves) -> int:
    """Shapes of x (B,H,W,C) and the nine leaves; returns C."""
    if x.dim() != 4:
        raise ValueError(f"convnext_block: x must be (B,H,W,C), got "
                         f"{tuple(x.shape)}")
    C = x.shape[-1]
    want = ((C, 1, 7, 7), (C,), (C,), (C,), (4 * C, C), (4 * C,), (C, 4 * C),
            (C,), (C,))
    for k, t, shape in zip(LEAVES, leaves, want):
        if tuple(t.shape) != shape:
            raise ValueError(f"convnext_block: p[{']['.join(map(repr, k))}] "
                             f"is {tuple(t.shape)}, expected {shape}")
    return C


def _gelu(t: torch.Tensor, exact_gelu: bool) -> torch.Tensor:
    return F.gelu(t, approximate="none" if exact_gelu else "tanh")


def _taps(w_dw: torch.Tensor) -> torch.Tensor:
    """(C,1,7,7) -> (7,7,C)."""
    C = w_dw.shape[0]
    return w_dw.reshape(C, 49).t().reshape(7, 7, C)


def convnext_block_ref(x: torch.Tensor, p: dict, exact_gelu: bool = False,
                       eps: float = 1e-6) -> torch.Tensor:
    """The reference composition, equal to models.blocks.ConvNeXtBlock with
    the same parameters: computes in x.dtype with an fp32 LayerNorm. The dw
    conv is `dwconv7x7_plain` on either device, so this form is plain
    PyTorch throughout and differentiable."""
    dt = x.dtype
    leaves = flatten_params(p)
    _check(x, leaves)
    w_dw, b_dw, ln_s, ln_b, w1, b1, w2, b2, gamma = leaves
    y = dwconv7x7_plain(x, _taps(w_dw), b_dw)
    y = F.layer_norm(y.float(), (x.shape[-1],), ln_s, ln_b, eps).to(dt)
    y = _gelu(F.linear(y, w1.to(dt), b1.to(dt)), exact_gelu)
    y = F.linear(y, w2.to(dt), b2.to(dt))
    return x + y * gamma.to(dt)


def plain_hidden(x: torch.Tensor, p: dict, exact_gelu: bool = False,
                 eps: float = 1e-6) -> torch.Tensor:
    """The hidden map h (B,H,W,4C) of the plain version, in x.dtype: dw7x7
    with fp32 taps, two-pass LayerNorm on the unrounded fp32 sum, yn rounded
    once, product 1 + b1 and the GELU in fp32, one rounding."""
    dt = x.dtype
    leaves = [t.float() for t in flatten_params(p)]
    C = _check(x, leaves)
    w_dw, b_dw, ln_s, ln_b, w1, b1 = leaves[:6]
    acc = F.conv2d(x.float().permute(0, 3, 1, 2), w_dw, b_dw, padding=3,
                   groups=C).permute(0, 2, 3, 1)
    mu = acc.mean(-1, keepdim=True)
    d = acc - mu
    var = (d * d).mean(-1, keepdim=True)
    yn = (d * torch.rsqrt(var + eps) * ln_s + ln_b).to(dt)
    h = F.linear(yn.float(), w1.to(dt).float()) + b1
    return _gelu(h, exact_gelu).to(dt)


def convnext_block_plain(x: torch.Tensor, p: dict, exact_gelu: bool = False,
                         eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with the kernel's places of
    rounding (module docstring). On the card TF32 must be off for both
    cuDNN and matmuls for the sums to be fp32."""
    dt = x.dtype
    h = plain_hidden(x, p, exact_gelu, eps)
    w2, b2, gamma = (t.float() for t in flatten_params(p)[6:])
    y = F.linear(h.float(), w2.to(dt).float()) + b2
    return (x.float() + y * gamma).to(dt)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    from ..csrc import build

    lib = build.load("convnext_block")
    lib.convnext_block_forward.argtypes = (
        [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                       ctypes.c_void_p])
    lib.convnext_block_forward.restype = ctypes.c_int
    lib.convnext_block_error_string.argtypes = [ctypes.c_int]
    lib.convnext_block_error_string.restype = ctypes.c_char_p
    return lib


def prepare(x: torch.Tensor, p: dict):
    """What `launch` takes beside x, made from p for x's dtype and device:
    (taps (7,7,C), b_dw, ln_s, ln_b, W1 (4C,C) in x.dtype, b1, W2 (C,4C) in
    x.dtype, b2, gamma), all contiguous, the others fp32."""
    leaves = flatten_params(p)
    _check(x, leaves)
    w_dw, b_dw, ln_s, ln_b, w1, b1, w2, b2, gamma = leaves

    def f32(t):
        return t.detach().to(x.device, torch.float32).contiguous()

    def rounded(t):
        return t.detach().to(x.device, x.dtype).contiguous()

    return (f32(_taps(w_dw)), f32(b_dw), f32(ln_s), f32(ln_b), rounded(w1),
            f32(b1), rounded(w2), f32(b2), f32(gamma))


def scratch(x: torch.Tensor):
    """The kernel's scratch for x (B,H,W,C): the fp32 dw sums, yn and the 4C
    wide hidden map."""
    B, H, W, C = x.shape
    return (torch.empty(B, H, W, C, device=x.device, dtype=torch.float32),
            torch.empty_like(x),
            torch.empty(B, H, W, 4 * C, device=x.device, dtype=x.dtype))


def launch(x: torch.Tensor, prepared, buffers, y: torch.Tensor,
           exact_gelu: bool, eps: float = 1e-6) -> None:
    """One block into y on PyTorch's current stream, on arguments from
    `prepare` and `scratch`: x, y (B,H,W,C) contiguous CUDA tensors."""
    global launches
    tensors = (x, *prepared, *buffers, y)
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("convnext_block_cuda: tensors must be 16-byte "
                             "aligned")
    B, H, W, C = x.shape
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.convnext_block_forward(
        *(t.data_ptr() for t in tensors), B, H, W, C, _DTYPE_CODE[x.dtype],
        int(bool(exact_gelu)), float(eps), stream)
    if err:
        raise RuntimeError(
            f"convnext_block launch failed: {err} "
            f"({lib.convnext_block_error_string(err).decode()}) at "
            f"{(B, H, W, C)} {x.dtype}")
    launches += 1


def convnext_block_cuda(x: torch.Tensor, p: dict, exact_gelu: bool = False,
                        eps: float = 1e-6) -> torch.Tensor:
    """The CUDA kernels on PyTorch's current stream. x must be a contiguous
    (B,H,W,C) CUDA tensor of float32 or bfloat16 with C a multiple of the
    16-byte vector (4 fp32, 8 bf16 channels)."""
    if not x.is_cuda:
        raise ValueError("convnext_block_cuda: x is not a CUDA tensor")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"convnext_block_cuda: dtype {x.dtype} not supported")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("convnext_block_cuda: x must be a contiguous "
                         f"(B,H,W,C) tensor, got shape {tuple(x.shape)} "
                         f"strides {x.stride()}")
    if x.shape[-1] % _VEC[x.dtype]:
        raise ValueError(f"convnext_block_cuda: C={x.shape[-1]} is not a "
                         f"multiple of {_VEC[x.dtype]} for {x.dtype}")
    y = torch.empty_like(x)
    launch(x, prepare(x, p), scratch(x), y, exact_gelu, eps)
    return y


class _ConvNeXtBlock(torch.autograd.Function):
    """forward = the kernel (the plain version for a CPU tensor); backward =
    autograd of convnext_block_ref on the saved x and the nine leaves."""

    @staticmethod
    def forward(ctx, exact_gelu, x, *leaves):
        ctx.exact_gelu = exact_gelu
        ctx.save_for_backward(x, *leaves)
        fwd = convnext_block_cuda if x.is_cuda else convnext_block_plain
        return fwd(x, unflatten_params(leaves), exact_gelu)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        exact_gelu = ctx.exact_gelu

        def ref(x, *leaves):
            return convnext_block_ref(x, unflatten_params(leaves), exact_gelu)

        return (None, *plain_backward(ref, ctx.saved_tensors,
                                      ctx.needs_input_grad[1:], grad_out))


def convnext_block(x: torch.Tensor, p: dict, exact_gelu: bool = False,
                   method: str = "auto") -> torch.Tensor:
    """One ConvNeXt block on x (B,H,W,C) with the parameters p. method
    "auto": the kernel on a CUDA tensor, the plain version on a CPU tensor;
    "pallas": the kernel, raises for a CPU tensor; "ref": the composition.
    "auto" and "pallas" are differentiable through the composition."""
    if method == "ref":
        return convnext_block_ref(x, p, exact_gelu)
    if method not in ("auto", "pallas"):
        raise ValueError(f"convnext_block: unknown method {method!r}")
    if not x.is_cuda:
        if method == "pallas":
            raise ValueError("convnext_block: method 'pallas' is the CUDA "
                             f"kernel and x is on {x.device}")
        if x.device.type != "cpu":
            raise ValueError(f"convnext_block: no kernel for device "
                             f"{x.device}")
    return _ConvNeXtBlock.apply(exact_gelu, x, *flatten_params(p))
